// Native transport + serving loop of multiverso_tpu_torch's async-PS
// plane: a copy of multiverso_tpu/native/mv_ps.cpp (the same wire, message
// types and meta whitelist), built with the host C++ compiler by
// multiverso_tpu_torch/ps/native.py at first use. Plain host C++, no CUDA.
//
// The C++ counterpart of the reference's network/server hot path (ref:
// src/net/mpi_net.h:195-216 serialized send; src/server.cpp:36-58
// Server::ProcessAdd/ProcessGet applying row deltas as they arrive;
// src/communicator.cpp:39-48 one recv loop per peer). The Python plane
// (ps/service.py, ps/wire.py) defines the wire format; this file speaks it
// without the interpreter in the loop:
//
//  * SERVER: accepted connection fds are adopted from Python; each gets a
//    C++ thread that reads frames, serves the hot ops (ADD_ROWS/GET_ROWS/
//    SET_ROWS/ADD_FULL/GET_FULL/PING) on registered host-backed shards
//    (a shard whose rows live in host memory: a CPU tensor) with plain row
//    arithmetic, and PUNTS anything else (unknown tables, shards on the
//    card, compressed wires, checkpoint state, stateful updaters) to a
//    Python callback, synchronously, so per-connection FIFO order is
//    preserved for the protocols that rely on it.
//  * CLIENT: framed sends built with sendmsg straight from caller buffers
//    (no Python bytes joins), one C++ recv thread per connection
//    completing counted adds (no per-reply Python wakeup) and copying get
//    replies into caller-provided numpy buffers.
//
// The wire format is wire.py's, byte for byte:
//   header <4sHHqIIq>: magic "MVPS", u16 type, u16 flags, i64 msg_id,
//                      u32 metalen, u32 narr, i64 paylen
//   body: meta JSON, then per blob: u8 dlen, dtype str, u8 ndim,
//         i64 shape[ndim], raw bytes.
//
// Thread-safety contract with Python: a registered shard's buffer is only
// ever mutated under its mvps mutex; Python's punt handlers for the same
// table are wrapped in the shard pin's lock/unlock by ps/service.py, so C++
// applies and Python applies (bf16 wire, checkpoint restore) serialize on
// the same lock. No GIL is taken anywhere on the hot path.

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>
#include <limits.h>

#include <algorithm>
#include <atomic>
#include <cctype>
#include <chrono>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

#pragma pack(push, 1)
struct WireHeader {
  char magic[4];
  uint16_t type;
  uint16_t flags;
  int64_t msg_id;
  uint32_t metalen;
  uint32_t narr;
  int64_t paylen;
};
#pragma pack(pop)
static_assert(sizeof(WireHeader) == 32, "wire header layout");

constexpr char kMagic[4] = {'M', 'V', 'P', 'S'};
constexpr int64_t kMaxMeta = 64ll << 20;
constexpr int64_t kMaxBlob = 4ll << 30;
constexpr int64_t kMaxFrame = kMaxMeta + 8 * kMaxBlob;

// message types (ps/service.py)
constexpr int MSG_REPLY_OK = 1;
constexpr int MSG_REPLY_ERR = 2;
constexpr int MSG_PING = 0x10;
constexpr int MSG_ADD_ROWS = 0x11;
constexpr int MSG_GET_ROWS = 0x12;
constexpr int MSG_SET_ROWS = 0x13;
constexpr int MSG_ADD_FULL = 0x14;
constexpr int MSG_GET_FULL = 0x15;

// ---------------------------------------------------------------------
// socket helpers
// ---------------------------------------------------------------------
bool recv_exact(int fd, void* buf, size_t n) {
  auto* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) {
      if (r < 0 && (errno == EINTR)) continue;
      return false;  // EOF, error, or timeout: connection is done
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool send_iov(int fd, struct iovec* iov, int cnt) {
  // chunk at IOV_MAX: the row-gather fanout sends one iovec entry per
  // (non-contiguous) table row, which can exceed the kernel limit.
  // sendmsg+MSG_NOSIGNAL, not writev: a peer-closed socket must yield
  // EPIPE, not a SIGPIPE that kills a non-Python embedder outright
  // (Python ignores the signal; a plain C host does not).
  while (cnt > 0) {
    struct msghdr mh = {};
    mh.msg_iov = iov;
    mh.msg_iovlen = static_cast<size_t>(std::min(cnt, IOV_MAX));
    ssize_t r = ::sendmsg(fd, &mh, MSG_NOSIGNAL);
    if (r < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    while (cnt > 0 && static_cast<size_t>(r) >= iov[0].iov_len) {
      r -= iov[0].iov_len;
      ++iov;
      --cnt;
    }
    if (cnt > 0 && r > 0) {
      iov[0].iov_base = static_cast<uint8_t*>(iov[0].iov_base) + r;
      iov[0].iov_len -= r;
    }
  }
  return true;
}

// ---------------------------------------------------------------------
// tiny JSON scanner — just enough for the metas OUR clients emit.
// Anything unexpected sets ok=false and the frame punts to Python.
// ---------------------------------------------------------------------
struct MetaScan {
  bool ok = false;          // parsed, and every key is whitelisted
  std::string table;        // meta["table"]
  std::string wire;         // meta["wire"] (empty = absent)
  bool sparse = false;      // meta["sparse"] truthy (stale-row get)
  int64_t worker_id = -1;   // meta["worker_id"] (sparse protocol)
};

const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
    ++p;
  return p;
}

// returns nullptr on malformed input; else one-past-end of the value
const char* skip_value(const char* p, const char* end, int depth);

const char* parse_string(const char* p, const char* end, std::string* out) {
  if (p >= end || *p != '"') return nullptr;
  ++p;
  while (p < end && *p != '"') {
    if (*p == '\\') {
      ++p;
      if (p >= end) return nullptr;
      // escapes never appear in table names we serve; punt via fail
      return nullptr;
    }
    if (out) out->push_back(*p);
    ++p;
  }
  if (p >= end) return nullptr;
  return p + 1;
}

const char* skip_object(const char* p, const char* end, int depth) {
  if (depth > 8 || p >= end || *p != '{') return nullptr;
  p = skip_ws(p + 1, end);
  if (p < end && *p == '}') return p + 1;
  while (p < end) {
    p = parse_string(p, end, nullptr);
    if (!p) return nullptr;
    p = skip_ws(p, end);
    if (p >= end || *p != ':') return nullptr;
    p = skip_value(skip_ws(p + 1, end), end, depth + 1);
    if (!p) return nullptr;
    p = skip_ws(p, end);
    if (p < end && *p == ',') {
      p = skip_ws(p + 1, end);
      continue;
    }
    if (p < end && *p == '}') return p + 1;
    return nullptr;
  }
  return nullptr;
}

const char* skip_array(const char* p, const char* end, int depth) {
  if (depth > 8 || p >= end || *p != '[') return nullptr;
  p = skip_ws(p + 1, end);
  if (p < end && *p == ']') return p + 1;
  while (p < end) {
    p = skip_value(p, end, depth + 1);
    if (!p) return nullptr;
    p = skip_ws(p, end);
    if (p < end && *p == ',') {
      p = skip_ws(p + 1, end);
      continue;
    }
    if (p < end && *p == ']') return p + 1;
    return nullptr;
  }
  return nullptr;
}

const char* skip_value(const char* p, const char* end, int depth) {
  if (p >= end || depth > 8) return nullptr;
  if (*p == '"') return parse_string(p, end, nullptr);
  if (*p == '{') return skip_object(p, end, depth);
  if (*p == '[') return skip_array(p, end, depth);
  if (!strncmp(p, "true", std::min<ptrdiff_t>(4, end - p)) && end - p >= 4)
    return p + 4;
  if (!strncmp(p, "false", std::min<ptrdiff_t>(5, end - p)) && end - p >= 5)
    return p + 5;
  if (!strncmp(p, "null", std::min<ptrdiff_t>(4, end - p)) && end - p >= 4)
    return p + 4;
  // number
  const char* q = p;
  while (q < end && (isdigit(static_cast<unsigned char>(*q)) || *q == '-' ||
                     *q == '+' || *q == '.' || *q == 'e' || *q == 'E'))
    ++q;
  return q == p ? nullptr : q;
}

// Whitelist scan: natively servable metas contain only {"table", "opt",
// "wire", "sparse", "worker_id"}. "opt" is skipped whole: the native path
// only serves shards whose updaters are opt-INSENSITIVE stateless
// accumulates (registration guarantees it), so its contents cannot
// matter; "sparse"/"worker_id" drive the natively-served stale-row GET
// branch. Any other key ("dump", "all", future extensions) punts the
// frame to Python.
MetaScan scan_meta(const char* p, size_t len) {
  MetaScan m;
  const char* end = p + len;
  p = skip_ws(p, end);
  if (p >= end || *p != '{') return m;
  p = skip_ws(p + 1, end);
  if (p < end && *p == '}') {
    m.ok = true;  // empty meta (PING)
    return m;
  }
  while (p < end) {
    std::string key;
    p = parse_string(p, end, &key);
    if (!p) return m;
    p = skip_ws(p, end);
    if (p >= end || *p != ':') return m;
    p = skip_ws(p + 1, end);
    if (key == "table") {
      p = parse_string(p, end, &m.table);
    } else if (key == "wire") {
      p = parse_string(p, end, &m.wire);
    } else if (key == "opt") {
      p = skip_object(p, end, 0);
    } else if (key == "sparse") {
      // json.dumps(True) -> "true"; anything else punts via parse fail
      if (end - p >= 4 && !strncmp(p, "true", 4)) {
        m.sparse = true;
        p += 4;
      } else if (end - p >= 5 && !strncmp(p, "false", 5)) {
        p += 5;
      } else {
        return m;
      }
    } else if (key == "worker_id") {
      // bounded digit parse: the buffer is NOT null-terminated, so
      // strtoll could walk past `end`
      int64_t v = 0;
      const char* q = p;
      while (q < end && isdigit(static_cast<unsigned char>(*q)) &&
             v < (1ll << 40))
        v = v * 10 + (*q++ - '0');
      if (q == p) return m;   // non-numeric (or negative): punt
      m.worker_id = v;
      p = q;
    } else {
      return m;  // unknown key: punt
    }
    if (!p) return m;
    p = skip_ws(p, end);
    if (p < end && *p == ',') {
      p = skip_ws(p + 1, end);
      continue;
    }
    if (p < end && *p == '}') {
      m.ok = true;
      return m;
    }
    return m;
  }
  return m;
}

// ---------------------------------------------------------------------
// blob parsing/building
// ---------------------------------------------------------------------
struct Blob {
  std::string dtype;         // e.g. "<i8", "<f4"
  std::vector<int64_t> shape;
  const uint8_t* data = nullptr;
  int64_t nbytes = 0;
  int64_t count = 0;
};

// parse blobs from a frame body; returns false on malformed layout
bool parse_blobs(const uint8_t* body, int64_t paylen, uint32_t metalen,
                 uint32_t narr, std::vector<Blob>* out) {
  int64_t off = metalen;
  for (uint32_t i = 0; i < narr; ++i) {
    if (off + 1 > paylen) return false;
    uint8_t dlen = body[off];
    off += 1;
    if (off + dlen + 1 > paylen) return false;
    Blob b;
    b.dtype.assign(reinterpret_cast<const char*>(body + off), dlen);
    off += dlen;
    uint8_t ndim = body[off];
    off += 1;
    if (off + 8ll * ndim > paylen) return false;
    b.count = 1;
    for (int d = 0; d < ndim; ++d) {
      int64_t s;
      memcpy(&s, body + off, 8);
      off += 8;
      if (s < 0) return false;
      // overflow guard: a wrapped count would make nbytes pass the bounds
      // check while the claimed shape promises far more data (the Python
      // parser is protected by reshape(); this port must check itself)
      if (s != 0 && b.count > kMaxBlob / s) return false;
      b.shape.push_back(s);
      b.count *= s;
    }
    // itemsize from the numpy dtype string's trailing digits
    size_t di = 0;
    while (di < b.dtype.size() &&
           !isdigit(static_cast<unsigned char>(b.dtype[di])))
      ++di;
    if (di >= b.dtype.size()) return false;
    int64_t itemsize = atoll(b.dtype.c_str() + di);
    if (itemsize <= 0 || itemsize > 16) return false;
    b.nbytes = b.count * itemsize;
    if (b.nbytes > kMaxBlob || off + b.nbytes > paylen) return false;
    b.data = body + off;
    off += b.nbytes;
    out->push_back(std::move(b));
  }
  return true;
}

// append one blob header to a byte vector
void put_blob_header(std::vector<uint8_t>* v, const char* dtype,
                     const int64_t* shape, int ndim) {
  size_t dlen = strlen(dtype);
  v->push_back(static_cast<uint8_t>(dlen));
  v->insert(v->end(), dtype, dtype + dlen);
  v->push_back(static_cast<uint8_t>(ndim));
  for (int i = 0; i < ndim; ++i) {
    const auto* p = reinterpret_cast<const uint8_t*>(&shape[i]);
    v->insert(v->end(), p, p + 8);
  }
}

void put_header(std::vector<uint8_t>* v, int type, int64_t msg_id,
                uint32_t metalen, uint32_t narr, int64_t paylen) {
  WireHeader h;
  memcpy(h.magic, kMagic, 4);
  h.type = static_cast<uint16_t>(type);
  h.flags = 0;
  h.msg_id = msg_id;
  h.metalen = metalen;
  h.narr = narr;
  h.paylen = paylen;
  const auto* p = reinterpret_cast<const uint8_t*>(&h);
  v->insert(v->end(), p, p + sizeof(h));
}

std::string json_escape(const std::string& s) {
  std::string out;
  for (char c : s) {
    if (c == '"' || c == '\\')
      out.push_back('\\'), out.push_back(c);
    else if (static_cast<unsigned char>(c) < 0x20)
      out += ' ';
    else
      out.push_back(c);
  }
  return out;
}

// ---------------------------------------------------------------------
// server
// ---------------------------------------------------------------------
struct Shard {
  std::string name;
  int64_t lo, n, ncol;
  int itemsize;          // 4 (f32) or 8 (f64)
  std::string dtype;     // "<f4" / "<f8"
  double sign;           // +1 accumulate, -1 sgd
  uint8_t* data;         // numpy buffer, rows (n+pad, ncol), C-contiguous
  uint8_t* dirty;        // bool [nworkers, n] or nullptr
  int64_t nworkers;
  std::mutex mu;
  std::atomic<uint64_t> adds{0}, applies{0};
};

using PuntCb = void (*)(uint64_t conn_id, const uint8_t* frame,
                        int64_t frame_len);

struct SrvConn {
  int fd;
  uint64_t id;
  std::mutex wmu;
  std::thread th;
  // lifecycle: a finished conn SHUTS DOWN its fd but does not close it
  // (closing would let the kernel reuse the fd number while a stale
  // mvps_send_raw still targets it) and stays in the registry until
  // reaped by the next adopt or by server close — both join the thread
  // first, so a SrvConn is never destroyed with a joinable thread.
  std::atomic<bool> done{false};
};

struct Server {
  PuntCb cb;
  int rank;
  std::atomic<bool> closed{false};
  std::mutex smu;  // shard registry
  std::unordered_map<std::string, std::shared_ptr<Shard>> shards;
  std::mutex cmu;  // conn registry
  std::unordered_map<uint64_t, std::shared_ptr<SrvConn>> conns;
  uint64_t next_conn = 1;
};

std::shared_ptr<Shard> find_shard(Server* s, const std::string& name) {
  std::lock_guard<std::mutex> g(s->smu);
  auto it = s->shards.find(name);
  return it == s->shards.end() ? nullptr : it->second;
}

void send_reply(Server* s, const std::shared_ptr<SrvConn>& c, int type,
                int64_t msg_id, const std::string& meta,
                const uint8_t* blob_head, size_t blob_head_len,
                const uint8_t* payload, int64_t payload_len, uint32_t narr) {
  std::vector<uint8_t> head;
  head.reserve(sizeof(WireHeader) + meta.size() + blob_head_len);
  put_header(&head, type, msg_id, static_cast<uint32_t>(meta.size()), narr,
             static_cast<int64_t>(meta.size()) + blob_head_len + payload_len);
  head.insert(head.end(), meta.begin(), meta.end());
  if (blob_head_len)
    head.insert(head.end(), blob_head, blob_head + blob_head_len);
  struct iovec iov[2];
  iov[0].iov_base = head.data();
  iov[0].iov_len = head.size();
  int cnt = 1;
  if (payload_len) {
    iov[1].iov_base = const_cast<uint8_t*>(payload);
    iov[1].iov_len = static_cast<size_t>(payload_len);
    cnt = 2;
  }
  std::lock_guard<std::mutex> g(c->wmu);
  send_iov(c->fd, iov, cnt);  // failure: conn thread will see EOF soon
}

void reply_ok_empty(Server* s, const std::shared_ptr<SrvConn>& c,
                    int64_t msg_id) {
  send_reply(s, c, MSG_REPLY_OK, msg_id, "{}", nullptr, 0, nullptr, 0, 0);
}

void reply_err(Server* s, const std::shared_ptr<SrvConn>& c, int64_t msg_id,
               const std::string& what) {
  std::string meta = "{\"error\": \"" + json_escape(what) + "\"}";
  send_reply(s, c, MSG_REPLY_ERR, msg_id, meta, nullptr, 0, nullptr, 0, 0);
}

// Blob payloads sit at arbitrary offsets inside the frame buffer (the
// meta length decides), so typed access must go through an alignment
// gate: aligned data is used in place, misaligned data is copied once
// into the (max_align'd) scratch vector.
const uint8_t* aligned_blob(const Blob& b, size_t align,
                            std::vector<uint8_t>* scratch) {
  if (reinterpret_cast<uintptr_t>(b.data) % align == 0) return b.data;
  scratch->assign(b.data, b.data + b.nbytes);
  return scratch->data();
}

// localize + bounds-check ids; returns false (and fills err) on violation
bool localize(const Shard& sh, const Blob& ids, std::vector<int64_t>* out,
              std::string* err) {
  out->resize(static_cast<size_t>(ids.count));
  for (int64_t i = 0; i < ids.count; ++i) {
    int64_t id;  // memcpy read: the blob may be misaligned in the frame
    memcpy(&id, ids.data + 8 * i, 8);
    int64_t l = id - sh.lo;
    if (l < 0 || l >= sh.n) {
      *err = "row ids outside shard [" + std::to_string(sh.lo) + ", " +
             std::to_string(sh.lo + sh.n) + ") of " + sh.name;
      return false;
    }
    (*out)[i] = l;
  }
  return true;
}

void mark_dirty(Shard& sh, const std::vector<int64_t>& local) {
  if (!sh.dirty) return;
  for (int64_t w = 0; w < sh.nworkers; ++w) {
    uint8_t* row = sh.dirty + w * sh.n;
    for (int64_t l : local) row[l] = 1;
  }
}

template <typename T>
void apply_add(Shard& sh, const std::vector<int64_t>& local,
               const uint8_t* vals, double sign) {
  const T* v = reinterpret_cast<const T*>(vals);
  T* d = reinterpret_cast<T*>(sh.data);
  const int64_t ncol = sh.ncol;
  if (sign > 0) {
    for (size_t i = 0; i < local.size(); ++i) {
      T* row = d + local[i] * ncol;
      const T* src = v + static_cast<int64_t>(i) * ncol;
      for (int64_t j = 0; j < ncol; ++j) row[j] += src[j];
    }
  } else {
    for (size_t i = 0; i < local.size(); ++i) {
      T* row = d + local[i] * ncol;
      const T* src = v + static_cast<int64_t>(i) * ncol;
      for (int64_t j = 0; j < ncol; ++j) row[j] -= src[j];
    }
  }
}

template <typename T>
void apply_full(Shard& sh, const uint8_t* vals, double sign) {
  const T* v = reinterpret_cast<const T*>(vals);
  T* d = reinterpret_cast<T*>(sh.data);
  const int64_t total = sh.n * sh.ncol;
  if (sign > 0)
    for (int64_t i = 0; i < total; ++i) d[i] += v[i];
  else
    for (int64_t i = 0; i < total; ++i) d[i] -= v[i];
}

// serve one hot frame natively; returns false if it must punt to Python
bool serve_native(Server* s, const std::shared_ptr<SrvConn>& c,
                  const WireHeader& h, const uint8_t* body,
                  std::vector<uint8_t>* scratch) {
  if (h.type == MSG_PING) {
    std::string meta = "{\"rank\": " + std::to_string(s->rank) + "}";
    send_reply(s, c, MSG_REPLY_OK, h.msg_id, meta, nullptr, 0, nullptr, 0,
               0);
    return true;
  }
  if (h.type != MSG_ADD_ROWS && h.type != MSG_GET_ROWS &&
      h.type != MSG_SET_ROWS && h.type != MSG_ADD_FULL &&
      h.type != MSG_GET_FULL)
    return false;
  MetaScan m = scan_meta(reinterpret_cast<const char*>(body), h.metalen);
  if (!m.ok || m.table.empty()) return false;
  if (!m.wire.empty() && m.wire != "none") return false;  // bf16 wire
  auto sh = find_shard(s, m.table);
  if (!sh) return false;  // unregistered table: Python handles (or waits)
  std::vector<Blob> blobs;
  if (!parse_blobs(body, h.paylen, h.metalen, h.narr, &blobs)) return false;

  std::string err;
  std::vector<int64_t> local;
  switch (h.type) {
    case MSG_ADD_ROWS: {
      if (blobs.size() != 2 || blobs[0].dtype != "<i8" ||
          blobs[1].dtype != sh->dtype)
        return false;
      const Blob &ids = blobs[0], &vals = blobs[1];
      if (ids.count == 0 || vals.shape.size() != 2 ||
          vals.shape[0] < ids.count || vals.shape[1] != sh->ncol)
        return false;
      if (!localize(*sh, ids, &local, &err)) {
        reply_err(s, c, h.msg_id, err);
        return true;
      }
      {
        const uint8_t* vdata =
            aligned_blob(vals, static_cast<size_t>(sh->itemsize), scratch);
        std::lock_guard<std::mutex> g(sh->mu);
        if (sh->itemsize == 4)
          apply_add<float>(*sh, local, vdata, sh->sign);
        else
          apply_add<double>(*sh, local, vdata, sh->sign);
        mark_dirty(*sh, local);
      }
      sh->adds.fetch_add(1, std::memory_order_relaxed);
      sh->applies.fetch_add(1, std::memory_order_relaxed);
      reply_ok_empty(s, c, h.msg_id);
      return true;
    }
    case MSG_SET_ROWS: {
      if (blobs.size() != 2 || blobs[0].dtype != "<i8" ||
          blobs[1].dtype != sh->dtype)
        return false;
      const Blob &ids = blobs[0], &vals = blobs[1];
      if (ids.count == 0 || vals.shape.size() != 2 ||
          vals.shape[0] < ids.count || vals.shape[1] != sh->ncol)
        return false;
      if (!localize(*sh, ids, &local, &err)) {
        reply_err(s, c, h.msg_id, err);
        return true;
      }
      {
        std::lock_guard<std::mutex> g(sh->mu);
        for (size_t i = 0; i < local.size(); ++i)
          memcpy(sh->data + local[i] * sh->ncol * sh->itemsize,
                 vals.data + static_cast<int64_t>(i) * sh->ncol *
                                 sh->itemsize,
                 static_cast<size_t>(sh->ncol) * sh->itemsize);
        mark_dirty(*sh, local);
      }
      reply_ok_empty(s, c, h.msg_id);
      return true;
    }
    case MSG_GET_ROWS: {
      if (blobs.size() != 1 || blobs[0].dtype != "<i8") return false;
      const Blob& ids = blobs[0];
      if (ids.count == 0) return false;
      if (m.sparse) {
        // stale-row protocol (ref matrix.cpp:475-572 GetOption.worker_id
        // + stale filter; python twin: RowShard.handle sparse branch):
        // read+clear this worker's dirty bits and reply
        // [mask bool[k], stale rows] — bits and gather under ONE lock
        // hold so the reply is atomic with the bits it cleared.
        if (!sh->dirty) {
          reply_err(s, c, h.msg_id,
                    sh->name + " was not created with num_workers; "
                    "sparse gets need dirty-bit tracking");
          return true;
        }
        if (m.worker_id < 0 || m.worker_id >= sh->nworkers)
          return false;  // odd worker_id: let Python shape the error
        if (!localize(*sh, ids, &local, &err)) {
          reply_err(s, c, h.msg_id, err);
          return true;
        }
        const int64_t rowbytes = sh->ncol * sh->itemsize;
        std::vector<uint8_t> mask(static_cast<size_t>(ids.count));
        int64_t nstale = 0;
        {
          std::lock_guard<std::mutex> g(sh->mu);
          uint8_t* bits = sh->dirty + m.worker_id * sh->n;
          // mask FIRST, clear second: a duplicate id in one request must
          // see the same bit at every occurrence (python-twin parity —
          // its vectorized mask read happens before the clear)
          for (int64_t i = 0; i < ids.count; ++i) {
            mask[i] = bits[local[i]] ? 1 : 0;
            nstale += mask[i];
          }
          for (int64_t i = 0; i < ids.count; ++i) bits[local[i]] = 0;
          scratch->resize(static_cast<size_t>(nstale) * rowbytes);
          int64_t w = 0;
          for (int64_t i = 0; i < ids.count; ++i)
            if (mask[i])
              memcpy(scratch->data() + (w++) * rowbytes,
                     sh->data + local[i] * rowbytes,
                     static_cast<size_t>(rowbytes));
        }
        // reply: blob0 = bool mask (numpy '|b1'), blob1 = stale rows
        std::vector<uint8_t> bh;
        int64_t mshape[1] = {ids.count};
        put_blob_header(&bh, "|b1", mshape, 1);
        bh.insert(bh.end(), mask.begin(), mask.end());
        int64_t rshape[2] = {nstale, sh->ncol};
        put_blob_header(&bh, sh->dtype.c_str(), rshape, 2);
        send_reply(s, c, MSG_REPLY_OK, h.msg_id, "{}", bh.data(),
                   bh.size(), scratch->data(),
                   static_cast<int64_t>(scratch->size()), 2);
        return true;
      }
      if (!localize(*sh, ids, &local, &err)) {
        reply_err(s, c, h.msg_id, err);
        return true;
      }
      const int64_t rowbytes = sh->ncol * sh->itemsize;
      scratch->resize(static_cast<size_t>(ids.count) * rowbytes);
      {
        std::lock_guard<std::mutex> g(sh->mu);
        for (size_t i = 0; i < local.size(); ++i)
          memcpy(scratch->data() + static_cast<int64_t>(i) * rowbytes,
                 sh->data + local[i] * rowbytes,
                 static_cast<size_t>(rowbytes));
      }
      std::vector<uint8_t> bh;
      int64_t shape[2] = {ids.count, sh->ncol};
      put_blob_header(&bh, sh->dtype.c_str(), shape, 2);
      send_reply(s, c, MSG_REPLY_OK, h.msg_id, "{}", bh.data(), bh.size(),
                 scratch->data(),
                 static_cast<int64_t>(scratch->size()), 1);
      return true;
    }
    case MSG_ADD_FULL: {
      if (blobs.size() != 1 || blobs[0].dtype != sh->dtype) return false;
      const Blob& delta = blobs[0];
      if (delta.count != sh->n * sh->ncol) {
        reply_err(s, c, h.msg_id,
                  "cannot reshape delta to shard (" + std::to_string(sh->n) +
                      ", " + std::to_string(sh->ncol) + ")");
        return true;
      }
      {
        const uint8_t* ddata =
            aligned_blob(delta, static_cast<size_t>(sh->itemsize),
                         scratch);
        std::lock_guard<std::mutex> g(sh->mu);
        if (sh->itemsize == 4)
          apply_full<float>(*sh, ddata, sh->sign);
        else
          apply_full<double>(*sh, ddata, sh->sign);
        if (sh->dirty)
          memset(sh->dirty, 1, static_cast<size_t>(sh->nworkers * sh->n));
      }
      sh->adds.fetch_add(1, std::memory_order_relaxed);
      sh->applies.fetch_add(1, std::memory_order_relaxed);
      reply_ok_empty(s, c, h.msg_id);
      return true;
    }
    case MSG_GET_FULL: {
      const int64_t nbytes = sh->n * sh->ncol * sh->itemsize;
      scratch->resize(static_cast<size_t>(nbytes));
      {
        std::lock_guard<std::mutex> g(sh->mu);
        memcpy(scratch->data(), sh->data, static_cast<size_t>(nbytes));
      }
      std::vector<uint8_t> bh;
      int64_t shape[2] = {sh->n, sh->ncol};
      put_blob_header(&bh, sh->dtype.c_str(), shape, 2);
      send_reply(s, c, MSG_REPLY_OK, h.msg_id, "{}", bh.data(), bh.size(),
                 scratch->data(), nbytes, 1);
      return true;
    }
  }
  return false;
}

void serve_conn(Server* s, std::shared_ptr<SrvConn> c) {
  std::vector<uint8_t> frame, scratch;
  while (!s->closed.load(std::memory_order_acquire)) {
    WireHeader h;
    if (!recv_exact(c->fd, &h, sizeof(h))) break;
    if (memcmp(h.magic, kMagic, 4) != 0) break;
    if (h.metalen > kMaxMeta || h.paylen < h.metalen || h.paylen > kMaxFrame)
      break;
    try {
      frame.resize(sizeof(h) + static_cast<size_t>(h.paylen));
    } catch (const std::bad_alloc&) {
      break;  // garbage length field: kill THIS conn, not the process
    }
    memcpy(frame.data(), &h, sizeof(h));
    if (!recv_exact(c->fd, frame.data() + sizeof(h),
                    static_cast<size_t>(h.paylen)))
      break;
    const uint8_t* body = frame.data() + sizeof(h);
    bool served = false;
    try {
      served = serve_native(s, c, h, body, &scratch);
    } catch (const std::bad_alloc&) {
      break;
    }
    if (served) continue;
    // punt: hand the WHOLE frame to Python, synchronously — the callback
    // (which sends its own reply through mvps_send_raw) returns before
    // the next frame is read, preserving per-connection FIFO order
    if (s->cb && !s->closed.load(std::memory_order_acquire))
      s->cb(c->id, frame.data(), static_cast<int64_t>(frame.size()));
  }
  ::shutdown(c->fd, SHUT_RDWR);
  c->done.store(true, std::memory_order_release);
}

// ---------------------------------------------------------------------
// client
// ---------------------------------------------------------------------
struct GetPending {
  uint8_t* out;
  int64_t out_nbytes;   // exact payload size expected (scatter: rows*rowbytes)
  // scatter mode (get fanout): reply row i lands at out + scatter[i]*rowbytes
  // instead of contiguously — the C++ side reassembles the multi-owner
  // reply straight into the caller's full result buffer
  std::vector<int64_t> scatter;
  int64_t rowbytes = 0;
  bool done = false;
  std::string err;  // empty = ok
};

struct Client {
  int fd = -1;
  std::thread rth;
  std::mutex wmu;
  std::mutex mu;
  std::condition_variable cv;
  int64_t next_id = 0;
  int64_t adds_issued = 0, adds_done = 0;
  bool shut = false;     // mvnet_shutdown ran (join happened)
  bool dead = false;
  std::string dead_err;
  std::string last_err;  // last per-op error for mvnet_last_error
  std::unordered_map<int64_t, int64_t> pending_adds;  // msg_id -> seq
  // ERR replies to counted adds, keyed by msg_id so the error binds to
  // exactly the op that failed (a conn is shared across tables; a sticky
  // conn-level error would misattribute). Bounded: an abandoned future
  // must not grow this forever.
  std::unordered_map<int64_t, std::string> add_errors;
  std::unordered_map<int64_t, std::shared_ptr<GetPending>> gets;
};
constexpr size_t kMaxAddErrors = 1024;

// extract meta["error"] from an ERR reply body (meta JSON); falls back to
// the raw meta text
std::string err_from_meta(const uint8_t* body, uint32_t metalen) {
  std::string meta(reinterpret_cast<const char*>(body), metalen);
  size_t k = meta.find("\"error\"");
  if (k == std::string::npos) return meta;
  size_t q1 = meta.find('"', k + 7 + 1);
  if (q1 == std::string::npos) return meta;
  size_t q2 = meta.find('"', q1 + 1);
  if (q2 == std::string::npos) return meta;
  return meta.substr(q1 + 1, q2 - q1 - 1);
}

void client_recv_loop(Client* c) {
  std::vector<uint8_t> body;
  for (;;) {
    WireHeader h;
    if (!recv_exact(c->fd, &h, sizeof(h))) break;
    if (memcmp(h.magic, kMagic, 4) != 0 || h.metalen > kMaxMeta ||
        h.paylen < h.metalen || h.paylen > kMaxFrame)
      break;
    try {
      body.resize(static_cast<size_t>(h.paylen));
    } catch (const std::bad_alloc&) {
      break;  // corrupt length: connection dies, process survives
    }
    if (!recv_exact(c->fd, body.data(), body.size())) break;
    std::unique_lock<std::mutex> lk(c->mu);
    auto ai = c->pending_adds.find(h.msg_id);
    if (ai != c->pending_adds.end()) {
      c->pending_adds.erase(ai);
      ++c->adds_done;
      if (h.type == MSG_REPLY_ERR && c->add_errors.size() < kMaxAddErrors)
        c->add_errors[h.msg_id] = err_from_meta(body.data(), h.metalen);
      c->cv.notify_all();
      continue;
    }
    auto gi = c->gets.find(h.msg_id);
    if (gi != c->gets.end()) {
      // entry stays in the map (the WAITER erases it): erasing here would
      // make a completed-but-not-yet-waited get indistinguishable from an
      // unknown id
      auto gp = gi->second;
      if (h.type == MSG_REPLY_ERR) {
        gp->err = err_from_meta(body.data(), h.metalen);
      } else {
        // reply layout: meta, then ONE blob whose payload must be exactly
        // the caller's buffer size
        std::vector<Blob> blobs;
        if (!parse_blobs(body.data(), h.paylen, h.metalen, h.narr,
                         &blobs) ||
            blobs.size() != 1) {
          gp->err = "malformed get reply";
        } else if (blobs[0].nbytes != gp->out_nbytes) {
          gp->err = "get reply size mismatch (" +
                    std::to_string(blobs[0].nbytes) + " != " +
                    std::to_string(gp->out_nbytes) + " bytes)";
        } else if (!gp->scatter.empty()) {
          // fanout reassembly: reply rows land at their ORIGINAL batch
          // positions in the caller's full buffer (copies under the lock
          // — a timed-out waiter erases the entry under this same lock,
          // so the copy can never race a freed caller buffer)
          const uint8_t* src = blobs[0].data;
          for (size_t i = 0; i < gp->scatter.size(); ++i)
            memcpy(gp->out + gp->scatter[i] * gp->rowbytes,
                   src + static_cast<int64_t>(i) * gp->rowbytes,
                   static_cast<size_t>(gp->rowbytes));
        } else {
          memcpy(gp->out, blobs[0].data,
                 static_cast<size_t>(gp->out_nbytes));
        }
      }
      gp->done = true;
      c->cv.notify_all();
      continue;
    }
    // reply to an op nobody tracks (timed-out get): drop
  }
  std::unique_lock<std::mutex> lk(c->mu);
  c->dead = true;
  c->dead_err = "connection lost";
  for (auto& kv : c->gets) {
    kv.second->err = "connection lost";
    kv.second->done = true;
  }
  c->gets.clear();
  c->pending_adds.clear();
  c->cv.notify_all();
}

// A fully-built request frame: iov entries point into the owned vectors
// and the caller's ids/vals buffers, so a Frame must outlive its send.
// Building is lock-free; only the send itself (and, for counted adds,
// the msg_id patch + seq assignment) happens under wmu.
struct Frame {
  std::vector<uint8_t> head;       // header + meta (+ ids blob header)
  std::vector<uint8_t> vals_head;
  struct iovec iov[4];
  int cnt = 0;
};

void client_build_frame(Frame* f, int type, int64_t msg_id,
                        const uint8_t* meta, int64_t metalen,
                        const int64_t* ids, int64_t k, const uint8_t* vals,
                        int64_t vnbytes, const char* vdtype,
                        const int64_t* vshape, int vndim) {
  uint32_t narr = 0;
  int64_t paylen = metalen;
  std::vector<uint8_t> ids_head;
  if (ids) {
    int64_t shape[1] = {k};
    put_blob_header(&ids_head, "<i8", shape, 1);
    paylen += static_cast<int64_t>(ids_head.size()) + 8 * k;
    ++narr;
  }
  if (vals) {
    put_blob_header(&f->vals_head, vdtype, vshape, vndim);
    paylen += static_cast<int64_t>(f->vals_head.size()) + vnbytes;
    ++narr;
  }
  f->head.reserve(sizeof(WireHeader) + static_cast<size_t>(metalen) +
                  ids_head.size());
  put_header(&f->head, type, msg_id, static_cast<uint32_t>(metalen), narr,
             paylen);
  f->head.insert(f->head.end(), meta, meta + metalen);
  if (ids) f->head.insert(f->head.end(), ids_head.begin(), ids_head.end());
  f->cnt = 0;
  f->iov[f->cnt].iov_base = f->head.data();
  f->iov[f->cnt++].iov_len = f->head.size();
  if (ids) {
    f->iov[f->cnt].iov_base = const_cast<int64_t*>(ids);
    f->iov[f->cnt++].iov_len = static_cast<size_t>(8 * k);
  }
  if (vals) {
    f->iov[f->cnt].iov_base = f->vals_head.data();
    f->iov[f->cnt++].iov_len = f->vals_head.size();
    f->iov[f->cnt].iov_base = const_cast<uint8_t*>(vals);
    f->iov[f->cnt++].iov_len = static_cast<size_t>(vnbytes);
  }
}

void frame_patch_msg_id(Frame* f, int64_t msg_id) {
  memcpy(f->head.data() + offsetof(WireHeader, msg_id), &msg_id,
         sizeof(msg_id));
}

bool client_send_frame(Client* c, int type, int64_t msg_id,
                       const uint8_t* meta, int64_t metalen,
                       const int64_t* ids, int64_t k, const uint8_t* vals,
                       int64_t vnbytes, const char* vdtype,
                       const int64_t* vshape, int vndim) {
  Frame f;
  client_build_frame(&f, type, msg_id, meta, metalen, ids, k, vals,
                     vnbytes, vdtype, vshape, vndim);
  std::lock_guard<std::mutex> g(c->wmu);
  return send_iov(c->fd, f.iov, f.cnt);
}

void client_mark_dead(Client* c, const char* why) {
  std::unique_lock<std::mutex> lk(c->mu);
  c->dead = true;
  c->dead_err = why;
  for (auto& kv : c->gets) {
    kv.second->err = why;
    kv.second->done = true;
  }
  c->gets.clear();
  c->pending_adds.clear();
  c->cv.notify_all();
}

}  // namespace

// ---------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------
extern "C" {

// ------------------------------- server -------------------------------
void* mvps_server_new(PuntCb cb, int rank) {
  auto* s = new Server();
  s->cb = cb;
  s->rank = rank;
  return s;
}

int mvps_server_adopt(void* srv, int fd) {
  auto* s = static_cast<Server*>(srv);
  if (s->closed.load()) {
    ::close(fd);
    return -1;
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  auto c = std::make_shared<SrvConn>();
  c->fd = fd;
  {
    std::lock_guard<std::mutex> g(s->cmu);
    // reap finished conns (join first — see SrvConn lifecycle note) so
    // reconnect churn doesn't grow the registry or leak fds
    for (auto it = s->conns.begin(); it != s->conns.end();) {
      if (it->second->done.load(std::memory_order_acquire)) {
        if (it->second->th.joinable()) it->second->th.join();
        ::close(it->second->fd);
        it = s->conns.erase(it);
      } else {
        ++it;
      }
    }
    c->id = s->next_conn++;
    s->conns[c->id] = c;
  }
  c->th = std::thread(serve_conn, s, c);
  return 0;
}

// Returns an opaque PIN (a heap shared_ptr<Shard>*) identifying THIS
// shard object, stable across same-name re-registration and across server
// close — the Python side locks/reads-stats through the pin, never
// through a name lookup that a re-registration could redirect mid-hold.
// Free with mvps_shard_pin_free when the Python shard dies.
void* mvps_register_shard(void* srv, const char* name, long long lo,
                          long long n, long long ncol, int itemsize,
                          double sign, void* data, void* dirty,
                          long long nworkers) {
  if (itemsize != 4 && itemsize != 8) return nullptr;
  auto* s = static_cast<Server*>(srv);
  auto sh = std::make_shared<Shard>();
  sh->name = name;
  sh->lo = lo;
  sh->n = n;
  sh->ncol = ncol;
  sh->itemsize = itemsize;
  sh->dtype = itemsize == 4 ? "<f4" : "<f8";
  sh->sign = sign;
  sh->data = static_cast<uint8_t*>(data);
  sh->dirty = static_cast<uint8_t*>(dirty);
  sh->nworkers = nworkers;
  {
    std::lock_guard<std::mutex> g(s->smu);
    s->shards[name] = sh;  // replace = re-created table with the same name
  }
  return new std::shared_ptr<Shard>(sh);
}

int mvps_unregister_shard(void* srv, const char* name) {
  auto* s = static_cast<Server*>(srv);
  std::lock_guard<std::mutex> g(s->smu);
  return s->shards.erase(name) ? 0 : -1;
}

// Python punt handlers for natively-registered tables wrap themselves in
// this lock so their buffer mutations serialize with C++ applies
void mvps_shard_pin_lock(void* pin) {
  (*static_cast<std::shared_ptr<Shard>*>(pin))->mu.lock();
}

void mvps_shard_pin_unlock(void* pin) {
  (*static_cast<std::shared_ptr<Shard>*>(pin))->mu.unlock();
}

void mvps_shard_pin_stats(void* pin, unsigned long long* adds,
                          unsigned long long* applies) {
  auto& sh = *static_cast<std::shared_ptr<Shard>*>(pin);
  *adds = sh->adds.load();
  *applies = sh->applies.load();
}

void mvps_shard_pin_free(void* pin) {
  delete static_cast<std::shared_ptr<Shard>*>(pin);
}

// raw pre-framed reply bytes from Python (wire.encode output)
int mvps_send_raw(void* srv, unsigned long long conn_id, const void* buf,
                  long long len) {
  auto* s = static_cast<Server*>(srv);
  std::shared_ptr<SrvConn> c;
  {
    std::lock_guard<std::mutex> g(s->cmu);
    auto it = s->conns.find(conn_id);
    if (it == s->conns.end()) return -1;  // conn died: reply dropped
    c = it->second;
  }
  struct iovec iov;
  iov.iov_base = const_cast<void*>(buf);
  iov.iov_len = static_cast<size_t>(len);
  std::lock_guard<std::mutex> g(c->wmu);
  return send_iov(c->fd, &iov, 1) ? 0 : -1;
}

void mvps_server_close(void* srv) {
  auto* s = static_cast<Server*>(srv);
  s->closed.store(true, std::memory_order_release);
  std::vector<std::shared_ptr<SrvConn>> conns;
  {
    std::lock_guard<std::mutex> g(s->cmu);
    for (auto& kv : s->conns) conns.push_back(kv.second);
    s->conns.clear();
  }
  for (auto& c : conns) ::shutdown(c->fd, SHUT_RDWR);
  for (auto& c : conns) {
    if (c->th.joinable()) c->th.join();
    ::close(c->fd);
  }
}

void mvps_server_free(void* srv) {
  auto* s = static_cast<Server*>(srv);
  mvps_server_close(srv);
  delete s;
}

// ------------------------------- client -------------------------------
void* mvnet_connect(const char* host, int port, double conn_timeout,
                    double io_timeout) {
  struct addrinfo hints = {}, *res = nullptr;
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  char portbuf[16];
  snprintf(portbuf, sizeof(portbuf), "%d", port);
  if (getaddrinfo(host, portbuf, &hints, &res) != 0 || !res) return nullptr;
  int fd = -1;
  for (auto* ai = res; ai; ai = ai->ai_next) {
    fd = ::socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
    if (fd < 0) continue;
    struct timeval tv;
    tv.tv_sec = static_cast<long>(conn_timeout);
    tv.tv_usec = static_cast<long>((conn_timeout - tv.tv_sec) * 1e6);
    setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
    if (::connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) break;
    ::close(fd);
    fd = -1;
  }
  freeaddrinfo(res);
  if (fd < 0) return nullptr;
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  // io timeout on SEND only: the recv loop must tolerate an idle socket
  // (python _Peer semantics — waiter timeouts bound blocked replies)
  struct timeval tv;
  tv.tv_sec = static_cast<long>(io_timeout);
  tv.tv_usec = static_cast<long>((io_timeout - tv.tv_sec) * 1e6);
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
  auto* c = new Client();
  c->fd = fd;
  c->rth = std::thread(client_recv_loop, c);
  return c;
}

long long mvnet_add(void* conn, int msg_type, const void* meta,
                    long long metalen, const int64_t* ids, long long k,
                    const void* vals, long long vnbytes, const char* vdtype,
                    const int64_t* vshape, int vndim,
                    long long* seq_out) {
  auto* c = static_cast<Client*>(conn);
  Frame f;  // built lock-free; msg_id patched in under wmu below
  client_build_frame(&f, msg_type, /*msg_id=*/0,
                     static_cast<const uint8_t*>(meta), metalen, ids, k,
                     static_cast<const uint8_t*>(vals), vnbytes, vdtype,
                     vshape, vndim);
  int64_t msg_id, seq;
  bool sent;
  {
    // seq assignment and the wire write happen under ONE wmu hold: two
    // threads adding concurrently must hit the wire in seq order, or a
    // reply to the later seq would mark the earlier add's future done
    // (adds_done is a plain counter) while its frame is still unsent —
    // result() could then report success before the op's ERR arrives.
    std::lock_guard<std::mutex> wg(c->wmu);
    {
      std::unique_lock<std::mutex> lk(c->mu);
      if (c->dead) return -1;
      msg_id = c->next_id++;
      seq = ++c->adds_issued;
      c->pending_adds[msg_id] = seq;
    }
    frame_patch_msg_id(&f, msg_id);
    sent = send_iov(c->fd, f.iov, f.cnt);
  }
  if (!sent) {
    client_mark_dead(c, "send failed");
    return -1;
  }
  if (seq_out) *seq_out = seq;
  return msg_id;
}

// 1 = an ERR reply was recorded for this add (message copied to buf, entry
// consumed), 0 = none
int mvnet_take_add_error(void* conn, long long msg_id, char* buf,
                         int buflen) {
  auto* c = static_cast<Client*>(conn);
  std::unique_lock<std::mutex> lk(c->mu);
  auto it = c->add_errors.find(msg_id);
  if (it == c->add_errors.end()) return 0;
  snprintf(buf, static_cast<size_t>(buflen), "%s", it->second.c_str());
  c->add_errors.erase(it);
  return 1;
}

long long mvnet_adds_done(void* conn) {
  auto* c = static_cast<Client*>(conn);
  std::unique_lock<std::mutex> lk(c->mu);
  return c->dead ? -1 : c->adds_done;
}

// highest add sequence issued so far — the fence point for order-
// sensitive callers (read under the same lock adds are issued under, so
// it can never lag a completed mvnet_add on any thread)
long long mvnet_adds_issued(void* conn) {
  auto* c = static_cast<Client*>(conn);
  std::unique_lock<std::mutex> lk(c->mu);
  return c->adds_issued;
}

// 0 = ok (all adds up to seq acked; per-op errors are separate — see
// mvnet_take_add_error), -1 = timeout, -3 = connection dead
int mvnet_wait_adds(void* conn, long long seq, double timeout) {
  auto* c = static_cast<Client*>(conn);
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::duration<double>(timeout);
  std::unique_lock<std::mutex> lk(c->mu);
  while (c->adds_done < seq && !c->dead) {
    if (c->cv.wait_until(lk, deadline) == std::cv_status::timeout &&
        c->adds_done < seq && !c->dead)
      return -1;
  }
  if (c->adds_done < seq && c->dead) {
    c->last_err = c->dead_err;
    return -3;
  }
  return 0;
}

long long mvnet_get_send(void* conn, int msg_type, const void* meta,
                         long long metalen, const int64_t* ids,
                         long long k, void* out, long long out_nbytes) {
  auto* c = static_cast<Client*>(conn);
  int64_t msg_id;
  auto gp = std::make_shared<GetPending>();
  gp->out = static_cast<uint8_t*>(out);
  gp->out_nbytes = out_nbytes;
  {
    std::unique_lock<std::mutex> lk(c->mu);
    if (c->dead) return -1;
    msg_id = c->next_id++;
    c->gets[msg_id] = gp;
  }
  if (!client_send_frame(c, msg_type, msg_id,
                         static_cast<const uint8_t*>(meta), metalen, ids, k,
                         nullptr, 0, nullptr, nullptr, 0)) {
    client_mark_dead(c, "send failed");
    return -1;
  }
  return msg_id;
}

// 0 = ok (out filled), -1 = timeout (entry dropped; late reply discarded),
// -2 = server error (message via mvnet_last_error), -3 = connection dead
int mvnet_get_wait(void* conn, long long msg_id, double timeout) {
  auto* c = static_cast<Client*>(conn);
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::duration<double>(timeout);
  std::unique_lock<std::mutex> lk(c->mu);
  auto it = c->gets.find(msg_id);
  std::shared_ptr<GetPending> gp =
      it == c->gets.end() ? nullptr : it->second;
  if (!gp) {  // unknown id: dead-swept (map cleared on death) or re-waited
    c->last_err = c->dead ? c->dead_err : "unknown get id";
    return -3;
  }
  while (!gp->done) {
    if (c->cv.wait_until(lk, deadline) == std::cv_status::timeout &&
        !gp->done) {
      c->gets.erase(msg_id);  // late reply must not touch the caller's out
      c->last_err = "timeout";
      return -1;
    }
  }
  c->gets.erase(msg_id);
  if (!gp->err.empty()) {
    c->last_err = gp->err;
    return gp->err == "connection lost" ? -3 : -2;
  }
  return 0;
}

// --------------------------- fan-out ops -------------------------------
// Partition a row batch by owner and send per-owner frames, all inside
// C — the per-owner numpy masking/copying on the Python side was ~100 us
// per 1024x128 op at world=8, a large slice of the client CPU budget.
// owner(id) = mod_owner ? id % world : id / rows_per (the two sharding
// rules of the async tables). Row payloads go out as per-row iovec
// entries straight from the caller's batch buffer — no gather copy.
//
// out_mid[r]: -2 = rank r owns no rows of this batch, -1 = rows present
// but conns[r] is NULL/dead or the send failed, >= 0 = msg_id of the
// counted add on conns[r]. out_seq[r] valid when out_mid[r] >= 0.
// Returns the number of ranks with rows.
int mvnet_add_fanout(void** conns, int world, int mod_owner,
                     long long rows_per, const void* meta,
                     long long metalen, const int64_t* ids, long long k,
                     const void* vals, long long rowbytes,
                     const char* vdtype, long long ncol,
                     long long* out_seq, long long* out_mid) {
  std::vector<std::vector<int64_t>> parts(world);
  for (long long i = 0; i < k; ++i) {
    int64_t r = mod_owner ? ids[i] % world : ids[i] / rows_per;
    if (r < 0 || r >= world) return -1;  // caller validated; belt only
    parts[static_cast<size_t>(r)].push_back(i);
  }
  int nranks = 0;
  std::vector<int64_t> owner_ids;
  std::vector<struct iovec> iov;
  for (int r = 0; r < world; ++r) {
    const auto& idx = parts[r];
    if (idx.empty()) {
      out_mid[r] = -2;
      continue;
    }
    ++nranks;
    auto* c = static_cast<Client*>(conns[r]);
    if (!c) {
      out_mid[r] = -1;
      continue;
    }
    const int64_t cnt = static_cast<int64_t>(idx.size());
    owner_ids.resize(static_cast<size_t>(cnt));
    for (int64_t i = 0; i < cnt; ++i) owner_ids[i] = ids[idx[i]];
    // head buffer: header + meta + ids blob header; ids data; vals blob
    // header; then one iovec entry per row of the original buffer. The
    // msg_id is patched in under wmu below — the frame body itself does
    // not depend on it, so the build stays outside the lock.
    std::vector<uint8_t> head, vals_head;
    int64_t ids_shape[1] = {cnt};
    std::vector<uint8_t> ids_head;
    put_blob_header(&ids_head, "<i8", ids_shape, 1);
    int64_t vshape[2] = {cnt, ncol};
    put_blob_header(&vals_head, vdtype, vshape, 2);
    int64_t paylen = metalen + static_cast<int64_t>(ids_head.size()) +
                     8 * cnt + static_cast<int64_t>(vals_head.size()) +
                     cnt * rowbytes;
    put_header(&head, MSG_ADD_ROWS, /*msg_id=*/0,
               static_cast<uint32_t>(metalen), 2, paylen);
    head.insert(head.end(), static_cast<const uint8_t*>(meta),
                static_cast<const uint8_t*>(meta) + metalen);
    head.insert(head.end(), ids_head.begin(), ids_head.end());
    iov.clear();
    iov.push_back({head.data(), head.size()});
    iov.push_back({owner_ids.data(), static_cast<size_t>(8 * cnt)});
    iov.push_back({vals_head.data(), vals_head.size()});
    const auto* vb = static_cast<const uint8_t*>(vals);
    for (int64_t i = 0; i < cnt; ++i)
      iov.push_back({const_cast<uint8_t*>(vb + idx[i] * rowbytes),
                     static_cast<size_t>(rowbytes)});
    int64_t msg_id, seq;
    bool ok;
    {
      // same seq-order-equals-wire-order rule as mvnet_add
      std::lock_guard<std::mutex> g(c->wmu);
      {
        std::unique_lock<std::mutex> lk(c->mu);
        if (c->dead) {
          out_mid[r] = -1;
          continue;
        }
        msg_id = c->next_id++;
        seq = ++c->adds_issued;
        c->pending_adds[msg_id] = seq;
      }
      memcpy(head.data() + offsetof(WireHeader, msg_id), &msg_id,
             sizeof(msg_id));
      ok = send_iov(c->fd, iov.data(), static_cast<int>(iov.size()));
    }
    if (!ok) {
      client_mark_dead(c, "send failed");
      out_mid[r] = -1;
      continue;
    }
    out_mid[r] = msg_id;
    out_seq[r] = seq;
  }
  return nranks;
}

// Get-side fanout: per-owner GET_ROWS requests whose replies SCATTER into
// the caller's full (k, ncol) buffer at the original batch positions —
// the Python-side reassembly (per-part mask writes) disappears.
// out_mid semantics as in mvnet_add_fanout.
int mvnet_get_fanout(void** conns, int world, int mod_owner,
                     long long rows_per, const void* meta,
                     long long metalen, const int64_t* ids, long long k,
                     void* out, long long rowbytes, long long* out_mid) {
  std::vector<std::vector<int64_t>> parts(world);
  for (long long i = 0; i < k; ++i) {
    int64_t r = mod_owner ? ids[i] % world : ids[i] / rows_per;
    if (r < 0 || r >= world) return -1;
    parts[static_cast<size_t>(r)].push_back(i);
  }
  int nranks = 0;
  std::vector<int64_t> owner_ids;
  for (int r = 0; r < world; ++r) {
    const auto& idx = parts[r];
    if (idx.empty()) {
      out_mid[r] = -2;
      continue;
    }
    ++nranks;
    auto* c = static_cast<Client*>(conns[r]);
    if (!c) {
      out_mid[r] = -1;
      continue;
    }
    const int64_t cnt = static_cast<int64_t>(idx.size());
    auto gp = std::make_shared<GetPending>();
    gp->out = static_cast<uint8_t*>(out);
    gp->out_nbytes = cnt * rowbytes;
    gp->rowbytes = rowbytes;
    gp->scatter = idx;  // original positions for the reply rows
    int64_t msg_id;
    {
      std::unique_lock<std::mutex> lk(c->mu);
      if (c->dead) {
        out_mid[r] = -1;
        continue;
      }
      msg_id = c->next_id++;
      c->gets[msg_id] = gp;
    }
    owner_ids.resize(static_cast<size_t>(cnt));
    for (int64_t i = 0; i < cnt; ++i) owner_ids[i] = ids[idx[i]];
    if (!client_send_frame(c, MSG_GET_ROWS, msg_id,
                           static_cast<const uint8_t*>(meta), metalen,
                           owner_ids.data(), cnt, nullptr, 0, nullptr,
                           nullptr, 0)) {
      client_mark_dead(c, "send failed");
      out_mid[r] = -1;
      continue;
    }
    out_mid[r] = msg_id;
  }
  return nranks;
}

// Drop a pending get without waiting: after this returns, the recv loop
// can never write into the caller's out buffer for this op (erase and
// reply-scatter serialize on the same lock). Called when a get future is
// abandoned (e.g. a sibling owner's failure aborted the whole op) so the
// shared out buffer can be safely garbage-collected.
void mvnet_get_cancel(void* conn, long long msg_id) {
  auto* c = static_cast<Client*>(conn);
  std::unique_lock<std::mutex> lk(c->mu);
  c->gets.erase(msg_id);
}

int mvnet_dead(void* conn) {
  auto* c = static_cast<Client*>(conn);
  std::unique_lock<std::mutex> lk(c->mu);
  return c->dead ? 1 : 0;
}

void mvnet_last_error(void* conn, char* buf, int buflen) {
  auto* c = static_cast<Client*>(conn);
  std::unique_lock<std::mutex> lk(c->mu);
  const std::string& e = c->last_err.empty() ? c->dead_err : c->last_err;
  snprintf(buf, static_cast<size_t>(buflen), "%s", e.c_str());
}

// Shutdown and free are split so Python can sever the connection eagerly
// (drop_native_conn, service close) while outstanding op futures still
// hold the Client — every API call on a shut-down Client is safe (it just
// reports dead). mvnet_free runs only when the LAST Python reference
// drops (NativeConn.__del__).
void mvnet_shutdown(void* conn) {
  auto* c = static_cast<Client*>(conn);
  {
    std::unique_lock<std::mutex> lk(c->mu);
    if (c->shut) return;
    c->shut = true;
  }
  ::shutdown(c->fd, SHUT_RDWR);
  if (c->rth.joinable()) c->rth.join();
  // recv loop has exited and marked dead/failed everything pending
}

void mvnet_free(void* conn) {
  auto* c = static_cast<Client*>(conn);
  mvnet_shutdown(conn);
  ::close(c->fd);
  delete c;
}

}  // extern "C"
