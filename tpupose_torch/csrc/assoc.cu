// Association: greedy connection accept + limb-major skeleton assembly.
//
// Replaces tpupose/ops/pallas_assoc.py::assoc_pallas (_assoc_kernel),
// bit-equal to decode/paf.py::greedy_accept + decode/assemble.py::assemble:
//
//   phase 1, per limb l: walk the score-sorted candidates (ts, ta, tb);
//     accept when the score is finite, neither endpoint slot is used and
//     the limb has accepted fewer than limits[l]; accepted connections
//     fill slots 0.. of the limb's table (at most n_conn kept); the walk
//     stops at the first -inf (the stream is sorted) or at the limit;
//   phase 2: walk (limb, connection) in decode order against a table of
//     P partial people: a connection matching one row extends it with
//     endpoint B (if B's slot differs), matching two rows merges them if
//     disjoint (else extends the older), matching none seeds a row at the
//     first free slot (only the limbs of seed_mask seed: COCO-18's first
//     17, BODY_25's all but the shoulder-ear limbs 18-19; seeds drop when
//     full); "older" is the lower creation stamp, ties to the first index.
//
// The skeleton's part count is a template parameter (kParts, instantiated
// at 18 and 25: a warp lane holds one part of a row, so at most 32); its
// limbs (L <= 32, a warp each in phase 1) and their part pairs are
// arguments.
//
// What bounds it on the H100: the latency of a sequential chain, not
// bytes or FLOPs: the contract fixes the order of phase 2, and each of its
// steps reads what the step before wrote. The bytes bound (the tables in,
// the people table out) is far below; the chain floor (phase-2 steps of
// the slowest image times one shared-memory round trip) is the tighter
// one. Design, one block per image, nothing but the tables in device
// memory:
//
//   * Phase 1: a warp per limb. The warp loads the limb's candidates 32
//     at a time, coalesced, and issues the next chunk's loads before it
//     resolves the current one. The used-slot masks are K-bit sets spread
//     over the lanes' registers (lane w holds slots 32w .. 32w + 31), so
//     every lane tests its own candidate against them with one shuffle
//     each. Within the chunk the lowest live lane is accepted (everything
//     before it is used, conflicting or accepted), its slots are
//     broadcast, and the lanes after it that share either slot die; the
//     loop takes one step per accepted connection and none per rejected
//     one.
//   * Phase 2: one warp, no block barrier. The row table is kept
//     part-major in shared memory (pitch P + 1, so that a part of 32 rows
//     and a row of kParts parts are both read without bank conflicts), and
//     beside it an index from each peak to the row that holds it. A step
//     reads the index at its two peaks and knows the matched rows, their
//     number and the case without looking at the table. A merge moves its
//     peaks' entries, an extend sets B's and clears the one it replaces,
//     a seed sets both.
//   * A peak can sit in two rows at once: a two-row match with overlap
//     extends the older row with B while the other may keep B. The index
//     cannot hold both, so it marks such a peak, and a step that meets a
//     marked peak scans the rows instead: lane w owns rows w, w + 32, ...,
//     keeps their active bits in a register, and tests them against the
//     two peaks; the match count and the two matched rows come from warp
//     reductions. The first free row comes from another reduction. A
//     merge or a seed is written by kParts lanes, one part each, an extend and
//     the running score and count by lane 0, with the reference's f32
//     addition order.
//
// PERF.md has the times of a scan on every step beside the index.
//
// The raw table (rows, score, cnt, active, stamp) is written once at the
// end by the whole block; the cull and compaction stay in torch.

#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBigStamp = 1 << 30;
constexpr int kMaxSlots = 32 * 32;     // a K-bit set over the 32 lanes
constexpr int kMaxPeople = 32 * 32;    // an active bit a row, 32 rows a lane
constexpr unsigned kAll = 0xffffffffu;

constexpr int kDup = -2;               // an index entry: the peak may sit in several rows

size_t smem_bytes(int parts, int limbs, int c, int p, int k) {
  return 5 * static_cast<size_t>(limbs) * c * 4 + static_cast<size_t>(limbs) * 4 +
         static_cast<size_t>(parts) * (p + 1) * 4 + 3 * static_cast<size_t>(p) * 4 +
         static_cast<size_t>(parts) * k * 4 + p;
}

// kBlocks: 32-row blocks of the table at most (P <= 32 * kBlocks), so that
// a scan is unrolled and its loads issued together; kScanOnly: every step
// scans (the test entry tp_assoc_scan holds that path to the plain version)
template <int kParts, int kBlocks, bool kScanOnly>
__global__ void __launch_bounds__(1024) assoc_kernel(const float* __restrict__ ts, const int* __restrict__ ta,
                             const int* __restrict__ tb, const float* __restrict__ sa,
                             const float* __restrict__ sb, const int* __restrict__ limits,
                             const int* __restrict__ part_pairs,  // (L, 2)
                             unsigned seed_mask,                  // bit l: limb l seeds
                             int limbs, int cap, int k, int n_conn, int P,
                             int* __restrict__ out_rows, float* __restrict__ out_score,
                             int* __restrict__ out_cnt, unsigned char* __restrict__ out_active,
                             int* __restrict__ out_stamp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pitch = P + 1;
  const int lc = limbs * n_conn;

  int* s_pa = reinterpret_cast<int*>(smem);   // (L, C) accepted connections
  int* s_pb = s_pa + lc;
  float* s_cs = reinterpret_cast<float*>(s_pb + lc);
  float* s_sa = s_cs + lc;
  float* s_sb = s_sa + lc;
  int* s_nacc = reinterpret_cast<int*>(s_sb + lc);   // (L,)
  int* s_rows = s_nacc + limbs;                      // [part][pitch]
  float* s_score = reinterpret_cast<float*>(s_rows + kParts * pitch);
  int* s_cnt = reinterpret_cast<int*>(s_score + P);
  int* s_stamp = s_cnt + P;
  int* s_idx = s_stamp + P;                          // (kParts * k,) the row of each peak
  unsigned char* s_active = reinterpret_cast<unsigned char*>(s_idx + kParts * k);

  for (int i = tid; i < kParts * pitch; i += blockDim.x) s_rows[i] = -1;
  for (int j = tid; j < P; j += blockDim.x) {
    s_score[j] = 0.f;
    s_cnt[j] = 0;
    s_stamp[j] = kBigStamp;
  }
  for (int i = tid; i < kParts * k; i += blockDim.x) s_idx[i] = -1;

  // ---- phase 1: greedy accept, a warp per limb -----------------------------
  if (warp < limbs) {
    const int l = warp;
    const size_t base = (static_cast<size_t>(b) * limbs + l) * cap;
    const int limit = limits[b * limbs + l];
    const int ap = part_pairs[2 * l], bp = part_pairs[2 * l + 1];
    unsigned used_a = 0, used_b = 0;   // slots 32 * lane .. 32 * lane + 31
    int n = 0;
    // the chunk in hand and the one in flight
    float c_ts = -INFINITY, c_sa = 0.f, c_sb = 0.f;
    int c_ta = 0, c_tb = 0;
    if (lane < cap) {
      c_ts = ts[base + lane];
      c_ta = ta[base + lane];
      c_tb = tb[base + lane];
      c_sa = sa[base + lane];
      c_sb = sb[base + lane];
    }
    bool done = n >= limit;
    for (int t0 = 0; t0 < cap && !done; t0 += 32) {
      const int tn = t0 + 32 + lane;
      float n_ts = -INFINITY, n_sa = 0.f, n_sb = 0.f;
      int n_ta = 0, n_tb = 0;
      if (tn < cap) {
        n_ts = ts[base + tn];
        n_ta = ta[base + tn];
        n_tb = tb[base + tn];
        n_sa = sa[base + tn];
        n_sb = sb[base + tn];
      }
      const bool in = t0 + lane < cap;
      // the walk ends at the first -inf: the lanes from it on take no part
      const unsigned neg = __ballot_sync(kAll, in && c_ts == -INFINITY);
      const unsigned before = neg ? (1u << (__ffs(neg) - 1)) - 1u : kAll;
      bool live = in && ((before >> lane) & 1u) && isfinite(c_ts);
      const unsigned wa = __shfl_sync(kAll, used_a, live ? c_ta >> 5 : 0);
      const unsigned wb = __shfl_sync(kAll, used_b, live ? c_tb >> 5 : 0);
      live = live && !((wa >> (c_ta & 31)) & 1u) && !((wb >> (c_tb & 31)) & 1u);
      unsigned lv = __ballot_sync(kAll, live);
      while (lv) {
        const int src = __ffs(lv) - 1;
        const int a = __shfl_sync(kAll, c_ta, src), bb = __shfl_sync(kAll, c_tb, src);
        if (lane == src && n < n_conn) {
          const int q = l * n_conn + n;
          s_pa[q] = ap * k + a;
          s_pb[q] = bp * k + bb;
          s_cs[q] = c_ts;
          s_sa[q] = c_sa;
          s_sb[q] = c_sb;
        }
        if (lane == (a >> 5)) used_a |= 1u << (a & 31);
        if (lane == (bb >> 5)) used_b |= 1u << (bb & 31);
        if (++n >= limit) {
          done = true;
          break;
        }
        live = live && lane > src && c_ta != a && c_tb != bb;
        lv = __ballot_sync(kAll, live);
      }
      if (neg) done = true;
      c_ts = n_ts;
      c_ta = n_ta;
      c_tb = n_tb;
      c_sa = n_sa;
      c_sb = n_sb;
    }
    if (lane == 0) s_nacc[l] = n < n_conn ? n : n_conn;
  }
  __syncthreads();

  // ---- phase 2: assembly over the accepted connections, one warp -------------
  if (warp == 0) {
    unsigned act = 0;     // bit i: row 32 * i + lane is active
    int seeded = 0;       // rows ever seeded: every row from here on is free
    int next_stamp = 0;
    for (int l = 0; l < limbs; ++l) {
      const int ap = part_pairs[2 * l], bp = part_pairs[2 * l + 1];
      int* col_a = s_rows + ap * pitch;
      int* col_b = s_rows + bp * pitch;
      const int nq = s_nacc[l];
      // the connection in hand and the next one, loaded a step ahead
      int n_pa = 0, n_pb = 0;
      float n_cs = 0.f, n_sb = 0.f;
      if (nq > 0) {
        n_pa = s_pa[l * n_conn];
        n_pb = s_pb[l * n_conn];
        n_cs = s_cs[l * n_conn];
        n_sb = s_sb[l * n_conn];
      }
      for (int q = 0; q < nq; ++q) {
        const int qi = l * n_conn + q;
        const int pa = n_pa, pb = n_pb;
        const float cs = n_cs, sbv = n_sb;
        if (q + 1 < nq) {
          n_pa = s_pa[qi + 1];
          n_pb = s_pb[qi + 1];
          n_cs = s_cs[qi + 1];
          n_sb = s_sb[qi + 1];
        }
        // the matched rows: from the index where it is exact, else from a scan
        const int ra = s_idx[pa], rb = s_idx[pb];
        int found, j1 = 0, j2 = 0;
        if (!kScanOnly && ra != kDup && rb != kDup) {
          found = (ra >= 0) + (rb >= 0 && rb != ra);
          j1 = ra >= 0 ? ra : rb;
          j2 = rb;
          if (found == 2 && rb < ra) {
            j1 = rb;
            j2 = ra;
          }
        } else {
          // every block of rows, without a branch (rows past P read row P - 1,
          // never active)
          unsigned m = 0;
#pragma unroll
          for (int i = 0; i < kBlocks; ++i) {
            const int j = min(32 * i + lane, P - 1);
            const int va = col_a[j], vb = col_b[j];
            m |= act & (static_cast<unsigned>((va == pa) | (vb == pb)) << i);
          }
          found = static_cast<int>(__reduce_add_sync(kAll, __popc(m)));
          if (found == 1 || found == 2) {
            // the matched rows in index order
            j1 = static_cast<int>(__reduce_min_sync(kAll, m ? 32 * (__ffs(m) - 1) + lane : INT_MAX));
            const unsigned rest = lane == (j1 & 31) ? m & ~(1u << (j1 >> 5)) : m;
            if (found == 2)
              j2 = static_cast<int>(
                  __reduce_min_sync(kAll, rest ? 32 * (__ffs(rest) - 1) + lane : INT_MAX));
          }
        }
        if (found == 1) {
          // extend the row with endpoint B if its slot differs
          const int old = col_b[j1];
          if (old != pb && lane == 0) {
            col_b[j1] = pb;
            s_cnt[j1] += 1;
            s_score[j1] = s_score[j1] + (sbv + cs);
            if (old >= 0 && s_idx[old] == j1) s_idx[old] = -1;
            s_idx[pb] = j1;   // no other row holds B: it matched none
          }
        } else if (found == 2) {
          if (s_stamp[j2] < s_stamp[j1]) {   // j1 the older (ties: the first)
            const int older = j2;
            j2 = j1;
            j1 = older;
          }
          const int row1 = lane < kParts ? s_rows[lane * pitch + j1] : -1;
          const int row2 = lane < kParts ? s_rows[lane * pitch + j2] : -1;
          const int old = __shfl_sync(kAll, row1, bp), b2 = __shfl_sync(kAll, row2, bp);
          if (__any_sync(kAll, row1 >= 0 && row2 >= 0)) {   // overlap: extend the older
            if (lane == 0) {
              col_b[j1] = pb;
              s_cnt[j1] += 1;
              s_score[j1] = s_score[j1] + (sbv + cs);
              if (old != pb) {
                if (old >= 0 && s_idx[old] == j1) s_idx[old] = -1;
                s_idx[pb] = b2 == pb ? kDup : j1;   // B may now sit in both rows
              }
            }
          } else {                                            // merge j2 into j1
            if (lane < kParts) {
              if (row2 >= 0) {
                s_rows[lane * pitch + j1] = row2;
                if (s_idx[row2] == j2) s_idx[row2] = j1;
              }
              s_rows[lane * pitch + j2] = -1;
            }
            if (lane == 0) {
              s_cnt[j1] += s_cnt[j2];
              s_score[j1] = s_score[j1] + (s_score[j2] + cs);
              s_cnt[j2] = 0;
              s_score[j2] = 0.f;
            }
            if (lane == (j2 & 31)) act &= ~(1u << (j2 >> 5));
          }
        } else if (found == 0 && ((seed_mask >> l) & 1u)) {
          // the first free row: an inactive one below the mark, else the mark
          const int n_blocks = (seeded + 31) >> 5;
          const unsigned span = n_blocks >= 32 ? kAll : (1u << n_blocks) - 1u;
          const unsigned fr = ~act & span;
          const int cand = fr ? 32 * (__ffs(fr) - 1) + lane : INT_MAX;
          const int j = min(static_cast<int>(__reduce_min_sync(kAll, cand)), seeded);
          if (j < P) {
            if (lane < kParts) s_rows[lane * pitch + j] = lane == ap ? pa : (lane == bp ? pb : -1);
            if (lane == (j & 31)) {
              act |= 1u << (j >> 5);
              s_cnt[j] = 2;
              s_score[j] = (s_sa[qi] + sbv) + cs;
              s_stamp[j] = next_stamp;
              s_idx[pa] = j;   // neither peak sits in another row: they matched none
              s_idx[pb] = j;
            }
            ++next_stamp;
            seeded = max(seeded, j + 1);
          }
        }
        __syncwarp();
      }
    }
    for (int i = 0; 32 * i < P; ++i) {
      const int j = 32 * i + lane;
      if (j < P) s_active[j] = static_cast<unsigned char>((act >> i) & 1u);
    }
  }
  __syncthreads();

  // ---- raw table out ----------------------------------------------------------
  for (int i = tid; i < P * kParts; i += blockDim.x)
    out_rows[static_cast<size_t>(b) * P * kParts + i] = s_rows[(i % kParts) * pitch + i / kParts];
  for (int j = tid; j < P; j += blockDim.x) {
    const size_t o = static_cast<size_t>(b) * P + j;
    out_score[o] = s_score[j];
    out_cnt[o] = s_cnt[j];
    out_active[o] = s_active[j];
    out_stamp[o] = s_stamp[j];
  }
}

struct Args {
  const void *ts, *ta, *tb, *sa, *sb, *limits, *part_pairs;
  unsigned seed_mask;
  int batch, limbs, cap, k, n_conn, P;
  void *rows, *score, *cnt, *active, *stamp, *stream;
};

template <int kParts, int kBlocks, bool kScanOnly>
cudaError_t launch(const Args& a, size_t smem) {
  cudaError_t err = tp_allow_smem(assoc_kernel<kParts, kBlocks, kScanOnly>, smem);
  if (err != cudaSuccess) return err;
  assoc_kernel<kParts, kBlocks, kScanOnly>
      <<<a.batch, 32 * a.limbs, smem, static_cast<cudaStream_t>(a.stream)>>>(
          static_cast<const float*>(a.ts), static_cast<const int*>(a.ta),
          static_cast<const int*>(a.tb), static_cast<const float*>(a.sa),
          static_cast<const float*>(a.sb), static_cast<const int*>(a.limits),
          static_cast<const int*>(a.part_pairs), a.seed_mask, a.limbs, a.cap, a.k, a.n_conn,
          a.P, static_cast<int*>(a.rows), static_cast<float*>(a.score),
          static_cast<int*>(a.cnt), static_cast<unsigned char*>(a.active),
          static_cast<int*>(a.stamp));
  return cudaGetLastError();
}

template <int kParts, bool kScanOnly>
cudaError_t run_parts(const Args& a, size_t smem) {
  if (a.P <= 64) return launch<kParts, 2, kScanOnly>(a, smem);
  if (a.P <= 256) return launch<kParts, 8, kScanOnly>(a, smem);
  return launch<kParts, 32, kScanOnly>(a, smem);
}

template <bool kScanOnly>
cudaError_t run(const Args& a, int parts) {
  if (a.P < 1 || a.P > kMaxPeople || a.limbs < 1 || a.limbs > 32 || a.k < 1 ||
      a.k > kMaxSlots || a.n_conn < 1 || a.cap < 0 || (parts != 18 && parts != 25))
    return cudaErrorInvalidValue;
  if (a.batch == 0) return cudaSuccess;
  const size_t smem = smem_bytes(parts, a.limbs, a.n_conn, a.P, a.k);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  return parts == 18 ? run_parts<18, kScanOnly>(a, smem) : run_parts<25, kScanOnly>(a, smem);
}

}  // namespace

// ts/sa/sb (B, L, cap) f32, ta/tb (B, L, cap) i32 slots below k, limits
// (B, L) i32, part_pairs (L, 2) i32 below parts (18 or 25), seed_mask bit l
// set where limb l may seed a row; outputs rows (B, P, parts) i32, score
// (B, P) f32, cnt (B, P) i32, active (B, P) u8, stamp (B, P) i32. One
// block of a warp per limb per image; L <= 32, k <= 1024, P <= 1024.
extern "C" int tp_assoc(const void* ts, const void* ta, const void* tb, const void* sa,
                        const void* sb, const void* limits, const void* part_pairs, int parts,
                        unsigned seed_mask, int batch, int limbs, int cap, int k, int n_conn,
                        int P, void* rows, void* score, void* cnt, void* active, void* stamp,
                        void* stream) {
  return run<false>({ts, ta, tb, sa, sb, limits, part_pairs, seed_mask, batch, limbs, cap, k,
                     n_conn, P, rows, score, cnt, active, stamp, stream}, parts);
}

// The same with every phase-2 step scanning the rows (the path the kernel
// takes where its index cannot say), for the card tests.
extern "C" int tp_assoc_scan(const void* ts, const void* ta, const void* tb, const void* sa,
                             const void* sb, const void* limits, const void* part_pairs,
                             int parts, unsigned seed_mask, int batch, int limbs, int cap, int k,
                             int n_conn, int P, void* rows, void* score, void* cnt, void* active,
                             void* stamp, void* stream) {
  return run<true>({ts, ta, tb, sa, sb, limits, part_pairs, seed_mask, batch, limbs, cap, k,
                    n_conn, P, rows, score, cnt, active, stamp, stream}, parts);
}
