// Native KV-transfer data plane (the NIXL/UCX role), the port's copy of
// llm_d_tpu/transfer/native/kv_transfer.cpp with the same wire.
//
// The reference moves P->D KV blocks with NIXL over UCX/RDMA
// (reference: ms-pd/values.yaml:38-39, Dockerfile.cuda:42-43).  Here the
// device side is staged through host RAM (copies out of and into the CUDA
// cache tensors), so the transport's job is moving big host buffers across
// pods without stalling the Python engine thread: a C++ server owns the
// registered slabs and serves them from a dedicated accept loop, off the
// GIL.  Built with g++ at first use (transport.py); no library is
// committed.
//
// Protocol (TCP, little-endian):
//   request:  u8 op, u32 uuid_len, uuid bytes
//     op=1 FETCH   -> reply u64 size (UINT64_MAX = not found), payload
//     op=2 RELEASE -> reply u8 ack(1); uuid queued for the engine to
//                      unpin its prefill blocks (polled via
//                      kvts_next_released)
//
// Exposed to Python via ctypes (no pybind11 in the image); see
// llm_d_tpu_torch/transfer/transport.py.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>

namespace {

constexpr uint64_t kNotFound = ~0ull;

bool read_full(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::read(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = ::write(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

struct Server {
  int listen_fd = -1;
  int port = 0;
  std::atomic<bool> stop{false};
  std::thread accept_thread;
  std::mutex mu;
  std::map<std::string, std::string> blobs;
  std::deque<std::string> released;
};

void handle_conn(Server* s, int fd) {
  // One request per connection: transfers are rare (per finished prefill)
  // and large, so connection setup is noise next to the payload.
  uint8_t op = 0;
  uint32_t uuid_len = 0;
  if (read_full(fd, &op, 1) && read_full(fd, &uuid_len, 4) &&
      uuid_len <= 4096) {
    std::string uuid(uuid_len, '\0');
    if (read_full(fd, uuid.data(), uuid_len)) {
      if (op == 1) {
        // FETCH: copy the blob out under the lock, stream it unlocked.
        std::string blob;
        bool found = false;
        {
          std::lock_guard<std::mutex> g(s->mu);
          auto it = s->blobs.find(uuid);
          if (it != s->blobs.end()) {
            blob = it->second;
            found = true;
          }
        }
        uint64_t size = found ? blob.size() : kNotFound;
        if (write_full(fd, &size, 8) && found) {
          write_full(fd, blob.data(), blob.size());
        }
      } else if (op == 2) {
        {
          std::lock_guard<std::mutex> g(s->mu);
          s->blobs.erase(uuid);
          s->released.push_back(uuid);
        }
        uint8_t ack = 1;
        write_full(fd, &ack, 1);
      }
    }
  }
  ::close(fd);
}

void accept_loop(Server* s) {
  while (!s->stop.load()) {
    int fd = ::accept(s->listen_fd, nullptr, nullptr);
    if (fd < 0) {
      if (s->stop.load()) break;
      continue;
    }
    int one = 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    std::thread(handle_conn, s, fd).detach();
  }
}

int connect_to(const char* host, int port, int timeout_ms) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  struct timeval tv;
  tv.tv_sec = timeout_ms / 1000;
  tv.tv_usec = (timeout_ms % 1000) * 1000;
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    // Not a dotted quad; the Python layer resolves names first.
    ::close(fd);
    return -1;
  }
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    int err = errno;  // why the connection failed, for the caller
    ::close(fd);
    errno = err;
    return -1;
  }
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return fd;
}

bool send_header(int fd, uint8_t op, const char* uuid) {
  uint32_t uuid_len = static_cast<uint32_t>(::strlen(uuid));
  return write_full(fd, &op, 1) && write_full(fd, &uuid_len, 4) &&
         write_full(fd, uuid, uuid_len);
}

}  // namespace

extern "C" {

void* kvts_create(const char* host, int port) {
  auto* s = new Server();
  s->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (s->listen_fd < 0) {
    delete s;
    return nullptr;
  }
  int one = 1;
  ::setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
  }
  if (::bind(s->listen_fd, reinterpret_cast<sockaddr*>(&addr),
             sizeof(addr)) != 0 ||
      ::listen(s->listen_fd, 64) != 0) {
    ::close(s->listen_fd);
    delete s;
    return nullptr;
  }
  socklen_t len = sizeof(addr);
  ::getsockname(s->listen_fd, reinterpret_cast<sockaddr*>(&addr), &len);
  s->port = ntohs(addr.sin_port);
  s->accept_thread = std::thread(accept_loop, s);
  return s;
}

int kvts_port(void* handle) { return static_cast<Server*>(handle)->port; }

void kvts_register(void* handle, const char* uuid, const char* data,
                   uint64_t size) {
  auto* s = static_cast<Server*>(handle);
  std::lock_guard<std::mutex> g(s->mu);
  s->blobs[uuid] = std::string(data, size);
}

int kvts_unregister(void* handle, const char* uuid) {
  auto* s = static_cast<Server*>(handle);
  std::lock_guard<std::mutex> g(s->mu);
  return s->blobs.erase(uuid) ? 1 : 0;
}

// Copies the next released uuid into uuid_out; returns its length, 0 when
// the queue is empty, -1 if cap is too small (uuid stays queued).
int kvts_next_released(void* handle, char* uuid_out, int cap) {
  auto* s = static_cast<Server*>(handle);
  std::lock_guard<std::mutex> g(s->mu);
  if (s->released.empty()) return 0;
  const std::string& u = s->released.front();
  if (static_cast<int>(u.size()) > cap) return -1;
  ::memcpy(uuid_out, u.data(), u.size());
  int n = static_cast<int>(u.size());
  s->released.pop_front();
  return n;
}

void kvts_destroy(void* handle) {
  auto* s = static_cast<Server*>(handle);
  s->stop.store(true);
  ::shutdown(s->listen_fd, SHUT_RDWR);
  ::close(s->listen_fd);
  if (s->accept_thread.joinable()) s->accept_thread.join();
  delete s;
}

// Fetches uuid's blob; *out receives a malloc'd buffer the caller frees
// with kvts_free.  Returns payload size, -1 on a protocol error, -2 when
// the server does not have the uuid, -3 when no connection was made (errno
// says why: a refused or unreachable peer).
int64_t kvts_fetch(const char* host, int port, const char* uuid,
                   int timeout_ms, char** out) {
  *out = nullptr;
  int fd = connect_to(host, port, timeout_ms);
  if (fd < 0) return -3;
  uint64_t size = 0;
  if (!send_header(fd, 1, uuid) || !read_full(fd, &size, 8)) {
    ::close(fd);
    return -1;
  }
  if (size == kNotFound) {
    ::close(fd);
    return -2;
  }
  char* buf = static_cast<char*>(::malloc(size ? size : 1));
  if (buf == nullptr || !read_full(fd, buf, size)) {
    ::free(buf);
    ::close(fd);
    return -1;
  }
  ::close(fd);
  *out = buf;
  return static_cast<int64_t>(size);
}

void kvts_free(char* buf) { ::free(buf); }

int kvts_release(const char* host, int port, const char* uuid,
                 int timeout_ms) {
  int fd = connect_to(host, port, timeout_ms);
  if (fd < 0) return 0;
  uint8_t ack = 0;
  bool ok = send_header(fd, 2, uuid) && read_full(fd, &ack, 1) && ack == 1;
  ::close(fd);
  return ok ? 1 : 0;
}

}  // extern "C"
