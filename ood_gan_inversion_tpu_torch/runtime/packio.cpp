// OGIPack: mmap'd packed-blob dataset reader (native IO runtime).
//
// Replaces the reference's LMDB file backend
// (BasicSR/basicsr/utils/file_client.py:33-85 + lmdb_util.py) with a
// dependency-free packed format tuned for sequential training reads:
// zero-copy mmap access, OS readahead hints per blob, and no per-read
// syscalls after open. Format (little-endian):
//
//   [0..8)   magic "OGIPACK1"
//   [8..16)  uint64 count
//   [16..24) uint64 index_offset
//   blobs... (back-to-back encoded images)
//   index at index_offset: count * { uint64 offset, uint64 size,
//                                    uint32 name_len, name bytes }
//
// Exposed via a C ABI for ctypes, so it builds with g++ alone.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Entry {
  uint64_t offset;
  uint64_t size;
  std::string name;
};

struct Pack {
  int fd = -1;
  uint8_t* base = nullptr;
  size_t length = 0;
  std::vector<Entry> entries;
};

uint64_t rd_u64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

uint32_t rd_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

}  // namespace

extern "C" {

void* ogipack_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 24) {
    ::close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* p = new Pack();
  p->fd = fd;
  p->base = static_cast<uint8_t*>(base);
  p->length = st.st_size;
  if (std::memcmp(p->base, "OGIPACK1", 8) != 0) {
    munmap(base, st.st_size);
    ::close(fd);
    delete p;
    return nullptr;
  }
  uint64_t count = rd_u64(p->base + 8);
  uint64_t index_offset = rd_u64(p->base + 16);
  const uint8_t* q = p->base + index_offset;
  const uint8_t* end = p->base + p->length;
  p->entries.reserve(count);
  for (uint64_t i = 0; i < count; ++i) {
    if (q + 20 > end) break;
    Entry e;
    e.offset = rd_u64(q);
    e.size = rd_u64(q + 8);
    uint32_t nl = rd_u32(q + 16);
    q += 20;
    if (q + nl > end) break;
    e.name.assign(reinterpret_cast<const char*>(q), nl);
    q += nl;
    p->entries.push_back(std::move(e));
  }
  // whole-file readahead hint for sequential epochs
  madvise(base, st.st_size, MADV_WILLNEED);
  return p;
}

long ogipack_count(void* h) {
  return h ? static_cast<Pack*>(h)->entries.size() : -1;
}

long ogipack_blob_size(void* h, long idx) {
  auto* p = static_cast<Pack*>(h);
  if (!p || idx < 0 || idx >= static_cast<long>(p->entries.size())) return -1;
  return p->entries[idx].size;
}

long ogipack_name_len(void* h, long idx) {
  auto* p = static_cast<Pack*>(h);
  if (!p || idx < 0 || idx >= static_cast<long>(p->entries.size())) return -1;
  return p->entries[idx].name.size();
}

long ogipack_name(void* h, long idx, char* dst, long cap) {
  auto* p = static_cast<Pack*>(h);
  if (!p || idx < 0 || idx >= static_cast<long>(p->entries.size())) return -1;
  const std::string& n = p->entries[idx].name;
  long k = n.size() < static_cast<size_t>(cap) ? n.size() : cap;
  std::memcpy(dst, n.data(), k);
  return k;
}

long ogipack_read(void* h, long idx, unsigned char* dst, long cap) {
  auto* p = static_cast<Pack*>(h);
  if (!p || idx < 0 || idx >= static_cast<long>(p->entries.size())) return -1;
  const Entry& e = p->entries[idx];
  if (e.offset + e.size > p->length) return -1;
  long k = e.size < static_cast<uint64_t>(cap) ? e.size : cap;
  std::memcpy(dst, p->base + e.offset, k);
  return k;
}

void ogipack_prefetch(void* h, long idx) {
  auto* p = static_cast<Pack*>(h);
  if (!p || idx < 0 || idx >= static_cast<long>(p->entries.size())) return;
  const Entry& e = p->entries[idx];
  // page-align the hint
  size_t page = sysconf(_SC_PAGESIZE);
  uint64_t start = (e.offset / page) * page;
  uint64_t len = e.size + (e.offset - start);
  madvise(p->base + start, len, MADV_WILLNEED);
}

void ogipack_close(void* h) {
  auto* p = static_cast<Pack*>(h);
  if (!p) return;
  if (p->base) munmap(p->base, p->length);
  if (p->fd >= 0) ::close(p->fd);
  delete p;
}

}  // extern "C"
