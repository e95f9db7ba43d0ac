// tpupose_torch native data feed: mmap'd packed-record reader with threaded
// zlib decompression. The port's copy of the JAX package's native/feed.cpp
// (same code, same file format).
//
// HDF5 inflates records on one thread behind h5py's global lock, and worker
// *processes* lose the parallel-inflate win to ~0.5 MB/record IPC. This
// loader keeps the file mmap'd, decompresses each record with one-shot zlib
// straight into caller-provided NumPy buffers, and fans a batch out over
// std::threads -- no process boundary, no per-record Python allocation,
// and ctypes releases the GIL for the whole call.
//
// File format (.tpr, little-endian; written by tpupose_torch/data/tpr.py):
//   header (32 bytes):
//     magic   8 bytes  "TPRECv01"
//     flags   u32      bit0 = static shapes (every record same H, W)
//     _pad    u32
//     count   u64      number of records
//     index_offset u64 byte offset of the index table
//   record payloads (arbitrary byte ranges, referenced by the index)
//   index: count entries x 88 bytes (TpfEntry below)
//
// Codec ids: 0 = raw bytes, 1 = zlib stream.
//
// Integrity: TpfEntry.reserved carries per-payload crc32s of the RAW
// (decompressed) bytes — low 32 bits image, high 32 bits mask — each
// mapped 0 -> 1 at write time so the value 0 still means "unchecked"
// (files written before the field existed verify as before; the format
// stays v01). Readers recompute the crc after decode and fail with
// TPF_ECRC on mismatch: a silent byte flip in a raw payload, or a zlib
// stream that inflates cleanly to wrong bytes, is now caught instead of
// feeding plausible wrong pixels to training.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

namespace {

constexpr char kMagic[8] = {'T', 'P', 'R', 'E', 'C', 'v', '0', '1'};

#pragma pack(push, 1)
struct TpfHeader {
  char magic[8];
  uint32_t flags;
  uint32_t pad;
  uint64_t count;
  uint64_t index_offset;
};

struct TpfEntry {
  uint64_t img_off, img_csize, img_rawsize;
  uint64_t mask_off, mask_csize, mask_rawsize;
  uint64_t meta_off, meta_size;
  uint32_t h, w;
  uint32_t img_codec, mask_codec;
  uint64_t reserved;
};
#pragma pack(pop)

static_assert(sizeof(TpfHeader) == 32, "header layout");
static_assert(sizeof(TpfEntry) == 88, "index layout");

struct TpfFile {
  const uint8_t* base = nullptr;
  size_t size = 0;
  const TpfHeader* header = nullptr;
  const TpfEntry* index = nullptr;
};

// Error codes (mirrored in tpupose_torch/data/tpr.py).
enum {
  TPF_OK = 0,
  TPF_EIO = -1,      // open/stat/mmap failure
  TPF_EFORMAT = -2,  // bad magic / truncated / index out of bounds
  TPF_ERANGE = -3,   // record index out of range
  TPF_ECODEC = -4,   // unknown codec id
  TPF_EINFLATE = -5, // zlib failure or size mismatch
  TPF_ECRC = -6,     // payload crc32 mismatch (corrupted data)
};

int check_span(const TpfFile* f, uint64_t off, uint64_t len) {
  if (off > f->size || len > f->size - off) return TPF_EFORMAT;
  return TPF_OK;
}

int read_blob(const TpfFile* f, uint64_t off, uint64_t csize,
              uint64_t rawsize, uint32_t codec, uint32_t expect_crc,
              uint8_t* out) {
  int rc = check_span(f, off, csize);
  if (rc != TPF_OK) return rc;
  const uint8_t* src = f->base + off;
  if (codec == 0) {
    if (csize != rawsize) return TPF_EFORMAT;
    std::memcpy(out, src, rawsize);
  } else if (codec == 1) {
    uLongf dst_len = rawsize;
    int z = uncompress(out, &dst_len, src, csize);
    if (z != Z_OK || dst_len != rawsize) return TPF_EINFLATE;
  } else {
    return TPF_ECODEC;
  }
  if (expect_crc != 0) {  // 0 = unchecked (pre-crc files)
    // zlib crc32 takes a 32-bit length; chunk so payloads >= 4 GiB
    // checksum all bytes (matching Python zlib.crc32, which is 64-bit
    // clean) instead of rawsize mod 2^32.
    uLong acc = crc32(0L, Z_NULL, 0);
    uint64_t done = 0;
    while (done < rawsize) {
      uInt n = (uInt)std::min<uint64_t>(rawsize - done, 0x40000000u);
      acc = crc32(acc, out + done, n);
      done += n;
    }
    uint32_t c = (uint32_t)acc;
    if (c == 0) c = 1;  // writer maps 0 -> 1 to keep 0 as the sentinel
    if (c != expect_crc) return TPF_ECRC;
  }
  return TPF_OK;
}

}  // namespace

extern "C" {

TpfFile* tpf_open(const char* path, int* err) {
  *err = TPF_EIO;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  if (st.st_size < (off_t)sizeof(TpfHeader)) {
    close(fd);
    *err = TPF_EFORMAT;
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);  // mmap keeps its own reference
  if (base == MAP_FAILED) return nullptr;

  auto* f = new TpfFile;
  f->base = static_cast<const uint8_t*>(base);
  f->size = st.st_size;
  f->header = reinterpret_cast<const TpfHeader*>(f->base);
  if (std::memcmp(f->header->magic, kMagic, 8) != 0 ||
      f->header->index_offset > f->size ||
      f->header->count > (f->size - f->header->index_offset) / sizeof(TpfEntry)) {
    munmap(base, st.st_size);
    delete f;
    *err = TPF_EFORMAT;
    return nullptr;
  }
  f->index =
      reinterpret_cast<const TpfEntry*>(f->base + f->header->index_offset);
  *err = TPF_OK;
  return f;
}

void tpf_close(TpfFile* f) {
  if (!f) return;
  munmap(const_cast<uint8_t*>(f->base), f->size);
  delete f;
}

uint64_t tpf_count(const TpfFile* f) { return f->header->count; }
uint32_t tpf_flags(const TpfFile* f) { return f->header->flags; }

int tpf_dims(const TpfFile* f, uint64_t i, uint32_t* h, uint32_t* w,
             uint64_t* meta_size) {
  if (i >= f->header->count) return TPF_ERANGE;
  const TpfEntry& e = f->index[i];
  *h = e.h;
  *w = e.w;
  *meta_size = e.meta_size;
  return TPF_OK;
}

int tpf_meta(const TpfFile* f, uint64_t i, uint8_t* out, uint64_t cap) {
  if (i >= f->header->count) return TPF_ERANGE;
  const TpfEntry& e = f->index[i];
  if (cap < e.meta_size) return TPF_ERANGE;
  int rc = check_span(f, e.meta_off, e.meta_size);
  if (rc != TPF_OK) return rc;
  std::memcpy(out, f->base + e.meta_off, e.meta_size);
  return TPF_OK;
}

// Decompress record i's image (h*w*3) and mask (h*w) into out buffers.
// Either pointer may be null to skip that blob.
int tpf_read(const TpfFile* f, uint64_t i, uint8_t* img, uint8_t* mask) {
  if (i >= f->header->count) return TPF_ERANGE;
  const TpfEntry& e = f->index[i];
  // format invariant: raw sizes must equal the pixel geometry — callers
  // size their buffers from (h, w), so a corrupted index entry with
  // larger raw sizes would otherwise overflow the destination buffer
  if (e.img_rawsize != 3ull * e.h * e.w || e.mask_rawsize != 1ull * e.h * e.w)
    return TPF_EFORMAT;
  if (img) {
    int rc = read_blob(f, e.img_off, e.img_csize, e.img_rawsize, e.img_codec,
                       (uint32_t)(e.reserved & 0xffffffffull), img);
    if (rc != TPF_OK) return rc;
  }
  if (mask) {
    int rc = read_blob(f, e.mask_off, e.mask_csize, e.mask_rawsize,
                       e.mask_codec, (uint32_t)(e.reserved >> 32), mask);
    if (rc != TPF_OK) return rc;
  }
  return TPF_OK;
}

// Threaded batch read: record idx[k] lands at img_out + k*img_stride and
// mask_out + k*mask_stride. Strides are in bytes; every record's raw
// sizes must fit its stride (checked). Returns first error, else TPF_OK.
int tpf_read_batch(const TpfFile* f, const uint64_t* idx, uint64_t n,
                   uint8_t* img_out, uint64_t img_stride, uint8_t* mask_out,
                   uint64_t mask_stride, int threads) {
  for (uint64_t k = 0; k < n; ++k) {
    if (idx[k] >= f->header->count) return TPF_ERANGE;
    const TpfEntry& e = f->index[idx[k]];
    if ((img_out && e.img_rawsize > img_stride) ||
        (mask_out && e.mask_rawsize > mask_stride))
      return TPF_ERANGE;
  }
  if (threads < 1) threads = 1;
  if ((uint64_t)threads > n) threads = (int)n;

  std::atomic<uint64_t> next{0};
  std::atomic<int> status{TPF_OK};
  auto worker = [&]() {
    for (;;) {
      uint64_t k = next.fetch_add(1);
      if (k >= n || status.load(std::memory_order_relaxed) != TPF_OK) break;
      int rc = tpf_read(f, idx[k], img_out ? img_out + k * img_stride : nullptr,
                        mask_out ? mask_out + k * mask_stride : nullptr);
      if (rc != TPF_OK) {
        int expected = TPF_OK;
        status.compare_exchange_strong(expected, rc);
      }
    }
  };

  if (threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
  return status.load();
}

}  // extern "C"
