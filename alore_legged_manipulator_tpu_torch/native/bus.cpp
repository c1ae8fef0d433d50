// Native UDP pub/sub transport core -- the DDS-seam datapath in C++.
//
// The reference deployment runtime rides Unitree's native DDS stack
// (Deployment/B2_deploy/deploy_real_b2z1_obj.py:61-81 creates
// ChannelPublisher/ChannelSubscriber over the vendored C++
// unitree_sdk2); the transport datapath there is native code, with
// Python only assembling messages.  This file is that layer for this
// framework: encode/decode, the socket hot path, the KEEP_LAST(1)
// per-topic store and the bounded receive inbox all live in C++, so a
// 100 Hz control loop never pays Python object churn per datagram.
//
// Wire format: IDENTICAL to runtime/transport.py (little-endian)
//   magic u16 = 0xA10E | tlen u16 | ndim u8 | dtype u8 (numpy char)
//   shape u32 x ndim | topic bytes | raw array bytes
// so native and pure-Python buses interoperate datagram-for-datagram
// (asserted in tests/test_native_bus.py).
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint16_t kMagic = 0xA10E;
constexpr size_t kMaxDgram = 60000;   // matches transport.py _MAX_DGRAM
constexpr size_t kRecvBuf = 65535;
constexpr size_t kInboxCap = 1024;    // bounded: drop-oldest (best effort)

struct Msg {
  std::string topic;
  char dtype = 0;
  std::vector<uint32_t> shape;
  std::vector<uint8_t> data;
};

struct Bus {
  int fd = -1;
  std::thread rx;
  std::atomic<bool> closed{false};
  std::mutex mu;
  std::condition_variable cv;
  std::vector<sockaddr_in> peers;
  std::deque<Msg> inbox;
  std::unordered_map<std::string, Msg> latest;  // KEEP_LAST(1)
  uint64_t dropped = 0;
};

bool parse_addr(const char* host, int port, sockaddr_in* out) {
  std::memset(out, 0, sizeof(*out));
  out->sin_family = AF_INET;
  out->sin_port = htons(static_cast<uint16_t>(port));
  return inet_pton(AF_INET, host, &out->sin_addr) == 1;
}

// Encode into `out`; returns false if the message exceeds one datagram.
bool encode(const char* topic, char dtype, int ndim, const uint32_t* shape,
            const void* data, size_t nbytes, std::vector<uint8_t>* out) {
  const size_t tlen = std::strlen(topic);
  const size_t total = 6 + 4 * static_cast<size_t>(ndim) + tlen + nbytes;
  if (total > kMaxDgram || tlen > 0xFFFF || ndim > 255) return false;
  out->resize(total);
  uint8_t* p = out->data();
  const uint16_t magic = kMagic, tl = static_cast<uint16_t>(tlen);
  std::memcpy(p, &magic, 2);
  std::memcpy(p + 2, &tl, 2);
  p[4] = static_cast<uint8_t>(ndim);
  p[5] = static_cast<uint8_t>(dtype);
  std::memcpy(p + 6, shape, 4 * static_cast<size_t>(ndim));
  std::memcpy(p + 6 + 4 * ndim, topic, tlen);
  std::memcpy(p + 6 + 4 * ndim + tlen, data, nbytes);
  return true;
}

bool decode(const uint8_t* buf, size_t len, Msg* m) {
  if (len < 6) return false;
  uint16_t magic, tlen;
  std::memcpy(&magic, buf, 2);
  std::memcpy(&tlen, buf + 2, 2);
  if (magic != kMagic) return false;
  const int ndim = buf[4];
  m->dtype = static_cast<char>(buf[5]);
  size_t off = 6;
  if (len < off + 4 * static_cast<size_t>(ndim) + tlen) return false;
  m->shape.resize(ndim);
  std::memcpy(m->shape.data(), buf + off, 4 * static_cast<size_t>(ndim));
  off += 4 * static_cast<size_t>(ndim);
  m->topic.assign(reinterpret_cast<const char*>(buf + off), tlen);
  off += tlen;
  m->data.assign(buf + off, buf + len);
  return true;
}

void rx_loop(Bus* b) {
  std::vector<uint8_t> buf(kRecvBuf);
  while (!b->closed.load(std::memory_order_relaxed)) {
    const ssize_t n = recv(b->fd, buf.data(), buf.size(), 0);
    if (n < 0) continue;  // timeout (SO_RCVTIMEO) or transient error
    Msg m;
    if (!decode(buf.data(), static_cast<size_t>(n), &m)) continue;
    std::lock_guard<std::mutex> lk(b->mu);
    b->latest[m.topic] = m;
    if (b->inbox.size() >= kInboxCap) {
      b->inbox.pop_front();
      ++b->dropped;
    }
    b->inbox.push_back(std::move(m));
    b->cv.notify_one();
  }
}

// Copy a Msg into caller-provided buffers.  Returns data byte count, or
// -2 if a buffer is too small (message is consumed either way -- the
// caps below are sized for the max datagram, so this is programmer
// error, not a runtime condition).
long long copy_out(const Msg& m, char* topic_out, int topic_cap,
                   char* dtype_out, int* ndim_out, uint32_t* shape_out,
                   int shape_cap, void* data_out, long long data_cap) {
  if (static_cast<int>(m.topic.size()) + 1 > topic_cap ||
      static_cast<int>(m.shape.size()) > shape_cap ||
      static_cast<long long>(m.data.size()) > data_cap)
    return -2;
  std::memcpy(topic_out, m.topic.c_str(), m.topic.size() + 1);
  *dtype_out = m.dtype;
  *ndim_out = static_cast<int>(m.shape.size());
  if (!m.shape.empty())
    std::memcpy(shape_out, m.shape.data(), 4 * m.shape.size());
  if (!m.data.empty()) std::memcpy(data_out, m.data.data(), m.data.size());
  return static_cast<long long>(m.data.size());
}

}  // namespace

extern "C" {

// Returns an opaque handle, or NULL.  *out_port receives the bound port
// (useful when port = 0 picks an ephemeral one).
void* alore_bus_create(const char* host, int port, int* out_port) {
  sockaddr_in addr;
  if (!parse_addr(host, port, &addr)) return nullptr;
  int fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) return nullptr;
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    close(fd);
    return nullptr;
  }
  timeval tv{0, 200000};  // 200 ms rx timeout so close() is prompt
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  sockaddr_in bound;
  socklen_t blen = sizeof(bound);
  getsockname(fd, reinterpret_cast<sockaddr*>(&bound), &blen);
  if (out_port) *out_port = ntohs(bound.sin_port);
  Bus* b = new Bus;
  b->fd = fd;
  b->rx = std::thread(rx_loop, b);
  return b;
}

int alore_bus_add_peer(void* h, const char* host, int port) {
  Bus* b = static_cast<Bus*>(h);
  sockaddr_in addr;
  if (!parse_addr(host, port, &addr)) return -1;
  std::lock_guard<std::mutex> lk(b->mu);
  b->peers.push_back(addr);
  return 0;
}

// Encode once, send to every peer (best-effort).  Returns 0, or -1 if
// the message does not fit one datagram.
int alore_bus_publish(void* h, const char* topic, char dtype, int ndim,
                      const uint32_t* shape, const void* data,
                      long long nbytes) {
  Bus* b = static_cast<Bus*>(h);
  std::vector<uint8_t> dgram;
  if (!encode(topic, dtype, ndim, shape, data, static_cast<size_t>(nbytes),
              &dgram))
    return -1;
  std::vector<sockaddr_in> peers;
  {
    std::lock_guard<std::mutex> lk(b->mu);
    peers = b->peers;
  }
  for (const auto& p : peers)
    sendto(b->fd, dgram.data(), dgram.size(), 0,
           reinterpret_cast<const sockaddr*>(&p), sizeof(p));
  return 0;
}

// Pop the oldest received message, blocking up to timeout_ms.  Returns
// data byte count, -1 on timeout, -2 on too-small buffers.
long long alore_bus_poll(void* h, int timeout_ms, char* topic_out,
                         int topic_cap, char* dtype_out, int* ndim_out,
                         uint32_t* shape_out, int shape_cap, void* data_out,
                         long long data_cap) {
  Bus* b = static_cast<Bus*>(h);
  std::unique_lock<std::mutex> lk(b->mu);
  if (!b->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                      [b] { return !b->inbox.empty() || b->closed.load(); }))
    return -1;
  if (b->inbox.empty()) return -1;
  Msg m = std::move(b->inbox.front());
  b->inbox.pop_front();
  lk.unlock();
  return copy_out(m, topic_out, topic_cap, dtype_out, ndim_out, shape_out,
                  shape_cap, data_out, data_cap);
}

// KEEP_LAST(1) read of a topic's most recent message (never consumes).
// Returns data byte count, -1 if the topic has never been received,
// -2 on too-small buffers.
long long alore_bus_latest(void* h, const char* topic, char* dtype_out,
                           int* ndim_out, uint32_t* shape_out, int shape_cap,
                           void* data_out, long long data_cap) {
  Bus* b = static_cast<Bus*>(h);
  std::lock_guard<std::mutex> lk(b->mu);
  auto it = b->latest.find(topic);
  if (it == b->latest.end()) return -1;
  char tbuf[8];  // topic echo not needed; reuse copy_out with a scratch
  int nd;
  (void)tbuf;
  const Msg& m = it->second;
  if (static_cast<int>(m.shape.size()) > shape_cap ||
      static_cast<long long>(m.data.size()) > data_cap)
    return -2;
  *dtype_out = m.dtype;
  nd = static_cast<int>(m.shape.size());
  *ndim_out = nd;
  if (nd) std::memcpy(shape_out, m.shape.data(), 4 * m.shape.size());
  if (!m.data.empty()) std::memcpy(data_out, m.data.data(), m.data.size());
  return static_cast<long long>(m.data.size());
}

// Messages dropped from the bounded inbox since creation (telemetry).
unsigned long long alore_bus_dropped(void* h) {
  Bus* b = static_cast<Bus*>(h);
  std::lock_guard<std::mutex> lk(b->mu);
  return b->dropped;
}

void alore_bus_close(void* h) {
  Bus* b = static_cast<Bus*>(h);
  b->closed.store(true);
  b->cv.notify_all();
  if (b->rx.joinable()) b->rx.join();
  if (b->fd >= 0) close(b->fd);
  delete b;
}

}  // extern "C"
