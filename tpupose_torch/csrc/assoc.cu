// Association: greedy connection accept + limb-major skeleton assembly.
//
// Replaces tpupose/ops/pallas_assoc.py::assoc_pallas (_assoc_kernel),
// bit-equal to decode/paf.py::_greedy_accept + decode/assemble.py::assemble:
//
//   phase 1, per limb l: walk the score-sorted candidates (ts, ta, tb);
//     accept when the score is finite, neither endpoint slot is used and
//     the limb has accepted fewer than limits[l]; accepted connections
//     fill slots 0.. of the limb's table (at most n_conn kept);
//   phase 2: walk (limb, connection) in decode order against a table of
//     P partial people: a connection matching one row extends it with
//     endpoint B (if B's slot differs), matching two rows merges them if
//     disjoint (else extends the older), matching none seeds a row at the
//     first free slot (limbs 17-18 never seed; seeds drop when full);
//     "older" is the lower creation stamp, ties to the first index.
//
// What bounds it on the H100: latency of a sequential chain, not bytes
// or FLOPs — the contract fixes the order. Design: one block per image
// and everything in shared memory. Phase 1 runs the 19 limbs' scans in
// parallel, one thread each, stopping at the first -inf candidate (the
// stream is sorted) or when the limb's limit is reached. Phase 2 visits
// only accepted connections; per step, thread j tests row j, two warp
// ballots per warp publish the matching and free rows, and thread 0
// resolves the case and applies it (at most two matched rows are ever
// read). The raw table (rows, score, cnt, active, stamp) is written
// once at the end; the cull and compaction stay in torch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kParts = 18;
constexpr int kSeedLimbs = 17;
constexpr int kBigStamp = 1 << 30;

struct Shared {
  unsigned char* used_a;  // (L, K)
  unsigned char* used_b;
  int* conn_pa;           // (L, C) global peak ids
  int* conn_pb;
  float* conn_cs;
  float* conn_sa;
  float* conn_sb;
  int* nacc;              // (L,)
  int* rows;              // (P, 18)
  float* score;           // (P,)
  int* cnt;
  int* active;
  int* stamp;
  unsigned* match_w;      // (warps,)
  unsigned* free_w;
};

size_t smem_bytes(int limbs, int k, int c, int p, int warps) {
  size_t b = 0;
  b += 2 * ((limbs * k + 15) & ~15);
  b += 5 * static_cast<size_t>(limbs) * c * 4;
  b += static_cast<size_t>(limbs) * 4;
  b += static_cast<size_t>(p) * kParts * 4 + 4 * static_cast<size_t>(p) * 4;
  b += 2 * static_cast<size_t>(warps) * 4;
  return b;
}

__global__ void assoc_kernel(const float* __restrict__ ts, const int* __restrict__ ta,
                             const int* __restrict__ tb, const float* __restrict__ sa,
                             const float* __restrict__ sb, const int* __restrict__ limits,
                             const int* __restrict__ part_pairs,  // (L, 2)
                             int limbs, int cap, int k, int n_conn, int P,
                             int* __restrict__ out_rows, float* __restrict__ out_score,
                             int* __restrict__ out_cnt, unsigned char* __restrict__ out_active,
                             int* __restrict__ out_stamp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warps = blockDim.x / 32;

  Shared s;
  unsigned char* ptr = smem;
  const int used_bytes = (limbs * k + 15) & ~15;
  s.used_a = ptr; ptr += used_bytes;
  s.used_b = ptr; ptr += used_bytes;
  s.conn_pa = reinterpret_cast<int*>(ptr); ptr += limbs * n_conn * 4;
  s.conn_pb = reinterpret_cast<int*>(ptr); ptr += limbs * n_conn * 4;
  s.conn_cs = reinterpret_cast<float*>(ptr); ptr += limbs * n_conn * 4;
  s.conn_sa = reinterpret_cast<float*>(ptr); ptr += limbs * n_conn * 4;
  s.conn_sb = reinterpret_cast<float*>(ptr); ptr += limbs * n_conn * 4;
  s.nacc = reinterpret_cast<int*>(ptr); ptr += limbs * 4;
  s.rows = reinterpret_cast<int*>(ptr); ptr += P * kParts * 4;
  s.score = reinterpret_cast<float*>(ptr); ptr += P * 4;
  s.cnt = reinterpret_cast<int*>(ptr); ptr += P * 4;
  s.active = reinterpret_cast<int*>(ptr); ptr += P * 4;
  s.stamp = reinterpret_cast<int*>(ptr); ptr += P * 4;
  s.match_w = reinterpret_cast<unsigned*>(ptr); ptr += warps * 4;
  s.free_w = reinterpret_cast<unsigned*>(ptr);

  for (int i = tid; i < used_bytes; i += blockDim.x) {
    s.used_a[i] = 0;
    s.used_b[i] = 0;
  }
  for (int i = tid; i < P * kParts; i += blockDim.x) s.rows[i] = -1;
  for (int j = tid; j < P; j += blockDim.x) {
    s.score[j] = 0.f;
    s.cnt[j] = 0;
    s.active[j] = 0;
    s.stamp[j] = kBigStamp;
  }
  __syncthreads();

  // ---- phase 1: greedy accept, one thread per limb ---------------------
  if (tid < limbs) {
    const int l = tid;
    const size_t base = (static_cast<size_t>(b) * limbs + l) * cap;
    const int limit = limits[b * limbs + l];
    const int ap = part_pairs[2 * l];
    const int bp = part_pairs[2 * l + 1];
    unsigned char* ua = s.used_a + l * k;
    unsigned char* ub = s.used_b + l * k;
    int n = 0;
    for (int t = 0; t < cap && n < limit; ++t) {
      const float sc = ts[base + t];
      if (sc == -INFINITY) break;  // sorted: only -inf follows
      if (!isfinite(sc)) continue;
      const int ai = ta[base + t];
      const int bi = tb[base + t];
      if (ua[ai] || ub[bi]) continue;
      ua[ai] = 1;
      ub[bi] = 1;
      if (n < n_conn) {
        const int q = l * n_conn + n;
        s.conn_pa[q] = ap * k + ai;
        s.conn_pb[q] = bp * k + bi;
        s.conn_cs[q] = sc;
        s.conn_sa[q] = sa[base + t];
        s.conn_sb[q] = sb[base + t];
      }
      ++n;
    }
    s.nacc[l] = n < n_conn ? n : n_conn;
  }
  __syncthreads();

  // ---- phase 2: assembly over the accepted connections, decode order ---
  int next_stamp = 0;  // meaningful in thread 0 only
  const int lane = tid % 32;
  const int warp = tid / 32;
  for (int l = 0; l < limbs; ++l) {
    const int ap = part_pairs[2 * l];
    const int bp = part_pairs[2 * l + 1];
    const int nq = s.nacc[l];
    for (int q = 0; q < nq; ++q) {
      const int qi = l * n_conn + q;
      const int pa = s.conn_pa[qi];
      const int pb = s.conn_pb[qi];
      bool m = false, fr = false;
      if (tid < P) {
        const int* row = s.rows + tid * kParts;
        m = s.active[tid] && (row[ap] == pa || row[bp] == pb);
        fr = !s.active[tid];
      }
      const unsigned mb = __ballot_sync(0xffffffffu, m);
      const unsigned fb = __ballot_sync(0xffffffffu, fr);
      if (lane == 0) {
        s.match_w[warp] = mb;
        s.free_w[warp] = fb;
      }
      __syncthreads();
      if (tid == 0) {
        int found = 0;
        for (int w = 0; w < warps; ++w) found += __popc(s.match_w[w]);
        const float cs = s.conn_cs[qi];
        const float sbv = s.conn_sb[qi];
        if (found == 0) {
          if (l < kSeedLimbs) {
            int j = -1;
            for (int w = 0; w < warps && j < 0; ++w)
              if (s.free_w[w]) j = w * 32 + __ffs(s.free_w[w]) - 1;
            if (j >= 0) {
              int* row = s.rows + j * kParts;
              for (int t = 0; t < kParts; ++t) row[t] = -1;
              row[ap] = pa;
              row[bp] = pb;
              s.cnt[j] = 2;
              s.score[j] = (s.conn_sa[qi] + sbv) + cs;
              s.active[j] = 1;
              s.stamp[j] = next_stamp;
              ++next_stamp;
            }
          }
        } else if (found <= 2) {
          // j1: matching row with the lowest stamp (first index on ties)
          int j1 = -1, j2 = -1;
          for (int w = 0; w < warps; ++w) {
            unsigned bits = s.match_w[w];
            while (bits) {
              const int j = w * 32 + __ffs(bits) - 1;
              bits &= bits - 1;
              if (j1 < 0 || s.stamp[j] < s.stamp[j1]) {
                j2 = j1;
                j1 = j;
              } else {
                j2 = j;
              }
            }
          }
          int* r1 = s.rows + j1 * kParts;
          bool extend;
          if (found == 1) {
            extend = r1[bp] != pb;
          } else {
            const int* r2 = s.rows + j2 * kParts;
            bool overlap = false;
            for (int t = 0; t < kParts; ++t) overlap |= (r1[t] >= 0) && (r2[t] >= 0);
            extend = overlap;
            if (!overlap) {  // merge j2 into j1
              for (int t = 0; t < kParts; ++t)
                if (r2[t] >= 0) r1[t] = r2[t];
              s.cnt[j1] += s.cnt[j2];
              s.score[j1] = s.score[j1] + (s.score[j2] + cs);
              int* w2 = s.rows + j2 * kParts;
              for (int t = 0; t < kParts; ++t) w2[t] = -1;
              s.cnt[j2] = 0;
              s.score[j2] = 0.f;
              s.active[j2] = 0;
            }
          }
          if (extend) {
            r1[bp] = pb;
            s.cnt[j1] += 1;
            s.score[j1] = s.score[j1] + (sbv + cs);
          }
        }
      }
      __syncthreads();
    }
  }

  // ---- raw table out ----------------------------------------------------
  for (int i = tid; i < P * kParts; i += blockDim.x)
    out_rows[static_cast<size_t>(b) * P * kParts + i] = s.rows[i];
  for (int j = tid; j < P; j += blockDim.x) {
    const size_t o = static_cast<size_t>(b) * P + j;
    out_score[o] = s.score[j];
    out_cnt[o] = s.cnt[j];
    out_active[o] = static_cast<unsigned char>(s.active[j] != 0);
    out_stamp[o] = s.stamp[j];
  }
}

}  // namespace

// ts/sa/sb (B, L, cap) f32, ta/tb (B, L, cap) i32, limits (B, L) i32,
// part_pairs (L, 2) i32; outputs rows (B, P, 18) i32, score (B, P) f32,
// cnt (B, P) i32, active (B, P) u8, stamp (B, P) i32. One block per
// image; P <= 1024.
extern "C" int tp_assoc(const void* ts, const void* ta, const void* tb, const void* sa,
                        const void* sb, const void* limits, const void* part_pairs, int batch,
                        int limbs, int cap, int k, int n_conn, int P, void* rows, void* score,
                        void* cnt, void* active, void* stamp, void* stream) {
  if (P < 1 || P > 1024 || limbs < 1 || limbs > 1024 || k < 1 || n_conn < 1)
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  int threads = ((P > limbs ? P : limbs) + 31) / 32 * 32;
  const size_t smem = smem_bytes(limbs, k, n_conn, P, threads / 32);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = tp_allow_smem(assoc_kernel, smem);
  if (err != cudaSuccess) return err;
  assoc_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ts), static_cast<const int*>(ta), static_cast<const int*>(tb),
      static_cast<const float*>(sa), static_cast<const float*>(sb),
      static_cast<const int*>(limits), static_cast<const int*>(part_pairs), limbs, cap, k,
      n_conn, P, static_cast<int*>(rows), static_cast<float*>(score), static_cast<int*>(cnt),
      static_cast<unsigned char*>(active), static_cast<int*>(stamp));
  return cudaGetLastError();
}
