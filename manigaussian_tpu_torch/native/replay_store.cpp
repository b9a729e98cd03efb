// Native replay record store: append-only binary log + offset index, mmap reads.
//
// Replaces the reference's one-pickle-file-per-transition disk replay
// (YARR task_uniform_replay_buffer.py:54 — each add() opens/writes/closes a
// file; each sample() re-opens and re-reads one) with a single data file per
// task and an int64 offset index:
//   * writes: buffered appends, one fsync at close;
//   * reads: the whole log is mmap'd once, record access is a pointer + length
//     (zero-copy into numpy via ctypes) — no syscalls in the sampling hot path;
//   * concurrent readers are safe (immutable log); the writer is single-owner.
//
// File layout:
//   <path>.bin : records back-to-back
//   <path>.idx : little-endian int64 offsets, [n+1] entries (0, end0, end1...)
//
// C API (ctypes-friendly), all functions return <0 / NULL on failure:
//   writer: rs_writer_open / rs_writer_add / rs_writer_count / rs_writer_close
//   reader: rs_reader_open / rs_reader_count / rs_reader_get / rs_reader_close

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Writer {
  FILE* bin = nullptr;
  FILE* idx = nullptr;
  int64_t offset = 0;
  int64_t count = 0;
};

struct Reader {
  int fd = -1;
  const uint8_t* data = nullptr;
  size_t size = 0;
  std::vector<int64_t> offsets;
};

std::string bin_path(const char* p) { return std::string(p) + ".bin"; }
std::string idx_path(const char* p) { return std::string(p) + ".idx"; }

}  // namespace

extern "C" {

void* rs_writer_open(const char* path) {
  auto* w = new Writer();
  // append mode: resuming an existing store continues the log
  w->bin = std::fopen(bin_path(path).c_str(), "ab");
  w->idx = std::fopen(idx_path(path).c_str(), "ab");
  if (!w->bin || !w->idx) {
    if (w->bin) std::fclose(w->bin);
    if (w->idx) std::fclose(w->idx);
    delete w;
    return nullptr;
  }
  struct stat st;
  if (stat(bin_path(path).c_str(), &st) == 0) w->offset = st.st_size;
  struct stat sti;
  if (stat(idx_path(path).c_str(), &sti) == 0) {
    int64_t entries = sti.st_size / sizeof(int64_t);
    w->count = entries > 0 ? entries - 1 : 0;
  }
  if (w->count == 0 && w->offset == 0) {
    int64_t zero = 0;
    std::fwrite(&zero, sizeof(zero), 1, w->idx);
  }
  return w;
}

int64_t rs_writer_add(void* handle, const uint8_t* data, int64_t len) {
  auto* w = static_cast<Writer*>(handle);
  if (!w || len < 0) return -1;
  if (len > 0 && std::fwrite(data, 1, static_cast<size_t>(len), w->bin) !=
                     static_cast<size_t>(len))
    return -1;
  w->offset += len;
  if (std::fwrite(&w->offset, sizeof(w->offset), 1, w->idx) != 1) return -1;
  return w->count++;
}

int64_t rs_writer_count(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  return w ? w->count : -1;
}

void rs_writer_close(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  if (!w) return;
  std::fflush(w->bin);
  std::fflush(w->idx);
  ::fsync(fileno(w->bin));
  ::fsync(fileno(w->idx));
  std::fclose(w->bin);
  std::fclose(w->idx);
  delete w;
}

void* rs_reader_open(const char* path) {
  auto* r = new Reader();
  // index
  FILE* idx = std::fopen(idx_path(path).c_str(), "rb");
  if (!idx) { delete r; return nullptr; }
  std::fseek(idx, 0, SEEK_END);
  long idx_size = std::ftell(idx);
  std::fseek(idx, 0, SEEK_SET);
  size_t entries = static_cast<size_t>(idx_size) / sizeof(int64_t);
  r->offsets.resize(entries);
  if (entries > 0 &&
      std::fread(r->offsets.data(), sizeof(int64_t), entries, idx) != entries) {
    std::fclose(idx);
    delete r;
    return nullptr;
  }
  std::fclose(idx);

  r->fd = ::open(bin_path(path).c_str(), O_RDONLY);
  if (r->fd < 0) { delete r; return nullptr; }
  struct stat st;
  if (fstat(r->fd, &st) != 0) { ::close(r->fd); delete r; return nullptr; }
  r->size = static_cast<size_t>(st.st_size);
  if (r->size > 0) {
    void* m = ::mmap(nullptr, r->size, PROT_READ, MAP_SHARED, r->fd, 0);
    if (m == MAP_FAILED) { ::close(r->fd); delete r; return nullptr; }
    r->data = static_cast<const uint8_t*>(m);
  }
  return r;
}

int64_t rs_reader_count(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  if (!r) return -1;
  return r->offsets.empty() ? 0
                            : static_cast<int64_t>(r->offsets.size()) - 1;
}

const uint8_t* rs_reader_get(void* handle, int64_t index, int64_t* len_out) {
  auto* r = static_cast<Reader*>(handle);
  if (!r || index < 0 ||
      index + 1 >= static_cast<int64_t>(r->offsets.size()))
    return nullptr;
  int64_t start = r->offsets[index];
  int64_t end = r->offsets[index + 1];
  if (end < start || end > static_cast<int64_t>(r->size)) return nullptr;
  *len_out = end - start;
  return r->data + start;
}

void rs_reader_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  if (!r) return;
  if (r->data) ::munmap(const_cast<uint8_t*>(r->data), r->size);
  if (r->fd >= 0) ::close(r->fd);
  delete r;
}

}  // extern "C"
