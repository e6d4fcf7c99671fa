// seldio: the mmap-backed reader and batch gatherer of the .seldpak dataset
// container, the port's own copy of the JAX package's loader.
//
// The reference loads its entire dataset through Python pickles
// (reference train.py:226-237), one blocking full-file deserialization.
// seldio reads a flat binary container instead (written once by
// seld_tpu_torch.data.native.pack_dataset, or by the JAX package's writer: the
// format is the same), memory-mapped at open, so startup is O(1) and the
// page cache streams tensors on demand; batch assembly (a shuffled row gather
// into one contiguous buffer for the copy to the device) runs here.
//
// Container layout (little-endian):
//   magic  "SELDPAK1"                (8 bytes)
//   n_tensors                        (int64)
//   per tensor: ndim (int64), shape (int64 * ndim), dtype code (int64,
//               0 = f32), byte offset (int64), byte length (int64)
//   ...tensor payloads (64-byte aligned)...
//
// C ABI (bound with ctypes by seld_tpu_torch/data/native/__init__.py):
//   seldio_open / seldio_close
//   seldio_num_tensors / seldio_tensor_info / seldio_tensor_data
//   seldio_gather_rows: out[i] = tensor[indices[i]] for row-major tensors.

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <vector>

namespace {

constexpr char kMagic[8] = {'S', 'E', 'L', 'D', 'P', 'A', 'K', '1'};
constexpr int kMaxDims = 8;

struct TensorInfo {
  int64_t ndim;
  int64_t shape[kMaxDims];
  int64_t dtype;  // 0 = float32
  int64_t offset;
  int64_t nbytes;
};

struct Pak {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  std::vector<TensorInfo> tensors;
};

int64_t read_i64(const uint8_t*& p) {
  int64_t v;
  std::memcpy(&v, p, sizeof(v));
  p += sizeof(v);
  return v;
}

}  // namespace

extern "C" {

void* seldio_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 16) {
    ::close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (mem == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* pak = new Pak();
  pak->fd = fd;
  pak->base = static_cast<const uint8_t*>(mem);
  pak->size = st.st_size;

  const uint8_t* p = pak->base;
  if (std::memcmp(p, kMagic, 8) != 0) {
    munmap(mem, st.st_size);
    ::close(fd);
    delete pak;
    return nullptr;
  }
  p += 8;
  // every header field and payload must lie inside the file: a truncated or
  // foreign file is refused, never read past its end
  const uint8_t* end = pak->base + pak->size;
  auto fits = [&](int64_t n_i64) { return (end - p) / 8 >= n_i64; };
  bool ok = true;
  int64_t n = read_i64(p);
  if (n < 0) ok = false;
  for (int64_t i = 0; ok && i < n; ++i) {
    TensorInfo info{};
    if (!fits(1)) { ok = false; break; }
    info.ndim = read_i64(p);
    if (info.ndim < 0 || info.ndim > kMaxDims || !fits(info.ndim + 3)) { ok = false; break; }
    for (int64_t d = 0; d < info.ndim; ++d) info.shape[d] = read_i64(p);
    info.dtype = read_i64(p);
    info.offset = read_i64(p);
    info.nbytes = read_i64(p);
    // an empty tensor's offset may lie past the end (nothing was written there)
    if (info.offset < 0 || info.nbytes < 0 ||
        (info.nbytes > 0 && info.offset > static_cast<int64_t>(pak->size) - info.nbytes)) {
      ok = false;
      break;
    }
    pak->tensors.push_back(info);
  }
  if (!ok) {
    munmap(mem, st.st_size);
    ::close(fd);
    delete pak;
    return nullptr;
  }
  return pak;
}

void seldio_close(void* handle) {
  if (!handle) return;
  auto* pak = static_cast<Pak*>(handle);
  munmap(const_cast<uint8_t*>(pak->base), pak->size);
  ::close(pak->fd);
  delete pak;
}

int64_t seldio_num_tensors(void* handle) {
  return handle ? static_cast<Pak*>(handle)->tensors.size() : -1;
}

// Fills ndim/shape/dtype for tensor `idx`; returns 0 on success.
int seldio_tensor_info(void* handle, int64_t idx, int64_t* ndim,
                       int64_t* shape /* int64[kMaxDims] */, int64_t* dtype) {
  if (!handle) return -1;
  auto* pak = static_cast<Pak*>(handle);
  if (idx < 0 || idx >= static_cast<int64_t>(pak->tensors.size())) return -2;
  const TensorInfo& t = pak->tensors[idx];
  *ndim = t.ndim;
  for (int64_t d = 0; d < t.ndim; ++d) shape[d] = t.shape[d];
  *dtype = t.dtype;
  return 0;
}

const void* seldio_tensor_data(void* handle, int64_t idx) {
  if (!handle) return nullptr;
  auto* pak = static_cast<Pak*>(handle);
  if (idx < 0 || idx >= static_cast<int64_t>(pak->tensors.size())) return nullptr;
  return pak->base + pak->tensors[idx].offset;
}

// Gather rows of a row-major tensor: out[i] = tensor[indices[i]].
// Returns 0 on success.
int seldio_gather_rows(void* handle, int64_t idx, const int64_t* indices,
                       int64_t n_rows, void* out) {
  if (!handle) return -1;
  auto* pak = static_cast<Pak*>(handle);
  if (idx < 0 || idx >= static_cast<int64_t>(pak->tensors.size())) return -2;
  const TensorInfo& t = pak->tensors[idx];
  if (t.ndim < 1) return -3;
  int64_t row_elems = 1;
  for (int64_t d = 1; d < t.ndim; ++d) row_elems *= t.shape[d];
  const int64_t row_bytes = row_elems * 4;  // f32
  const uint8_t* src = pak->base + t.offset;
  uint8_t* dst = static_cast<uint8_t*>(out);
  for (int64_t i = 0; i < n_rows; ++i) {
    const int64_t r = indices[i];
    if (r < 0 || r >= t.shape[0]) return -4;
    std::memcpy(dst + i * row_bytes, src + r * row_bytes, row_bytes);
  }
  return 0;
}

}  // extern "C"
