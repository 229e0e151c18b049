// Sanitizer smoke program for the native async-PS transport (mv_ps.cpp),
// a copy of multiverso_tpu/native/mv_ps_smoke.cpp.
//
// Exercises every exported entry point through real sockets and real
// threads so ASan/UBSan (and TSan, in a second build) see the
// actual concurrency: a server with a registered shard and a punt
// callback, two client connections doing adds (single + fanout), gets
// (plain, scatter fanout, full), an error reply, a punted message, a
// cancelled get, and a hard connection drop with futures outstanding.
//
// Build/run: tests/test_torch_native_transport.py builds it with
// mv_ps.cpp under -fsanitize=address,undefined and under -fsanitize=thread
// The smoke asserts on VALUES, not just survival: the shard contents
// after the op sequence must equal the arithmetic done.

#include <arpa/inet.h>
#include <assert.h>
#include <netinet/in.h>
#include <stdio.h>
#include <string.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

// C API of mv_ps.cpp
extern "C" {
typedef void (*PuntCb)(uint64_t, const uint8_t*, int64_t);
void* mvps_server_new(PuntCb, int);
int mvps_server_adopt(void*, int);
void* mvps_register_shard(void*, const char*, long long, long long,
                          long long, int, double, void*, void*, long long);
void mvps_shard_pin_lock(void*);
void mvps_shard_pin_unlock(void*);
void mvps_shard_pin_stats(void*, unsigned long long*, unsigned long long*);
void mvps_shard_pin_free(void*);
int mvps_send_raw(void*, unsigned long long, const void*, long long);
void mvps_server_close(void*);
void mvps_server_free(void*);
void* mvnet_connect(const char*, int, double, double);
long long mvnet_add(void*, int, const void*, long long, const int64_t*,
                    long long, const void*, long long, const char*,
                    const int64_t*, int, long long*);
int mvnet_take_add_error(void*, long long, char*, int);
long long mvnet_adds_done(void*);
long long mvnet_adds_issued(void*);
int mvnet_wait_adds(void*, long long, double);
long long mvnet_get_send(void*, int, const void*, long long,
                         const int64_t*, long long, void*, long long);
int mvnet_get_wait(void*, long long, double);
void mvnet_get_cancel(void*, long long);
int mvnet_add_fanout(void**, int, int, long long, const void*, long long,
                     const int64_t*, long long, const void*, long long,
                     const char*, long long, long long*, long long*);
int mvnet_get_fanout(void**, int, int, long long, const void*, long long,
                     const int64_t*, long long, void*, long long,
                     long long*);
int mvnet_dead(void*);
void mvnet_last_error(void*, char*, int);
void mvnet_shutdown(void*);
void mvnet_free(void*);
}

namespace {

std::atomic<int> g_punts{0};
void* g_server = nullptr;

// minimal wire constants (must match mv_ps.cpp / wire.py)
#pragma pack(push, 1)
struct Hdr {
  char magic[4];
  uint16_t type, flags;
  int64_t msg_id;
  uint32_t metalen, narr;
  int64_t paylen;
};
#pragma pack(pop)

void punt_cb(uint64_t conn_id, const uint8_t* frame, int64_t len) {
  // reply ERR to whatever punted (exercises mvps_send_raw from a foreign
  // thread, the path Python's handler reply takes)
  assert(len >= (int64_t)sizeof(Hdr));
  Hdr h;
  memcpy(&h, frame, sizeof(h));
  ++g_punts;
  const char* meta = "{\"error\": \"smoke punt\"}";
  Hdr r;
  memcpy(r.magic, "MVPS", 4);
  r.type = 2;  // MSG_REPLY_ERR
  r.flags = 0;
  r.msg_id = h.msg_id;
  r.metalen = (uint32_t)strlen(meta);
  r.narr = 0;
  r.paylen = (int64_t)strlen(meta);
  std::vector<uint8_t> buf(sizeof(r) + strlen(meta));
  memcpy(buf.data(), &r, sizeof(r));
  memcpy(buf.data() + sizeof(r), meta, strlen(meta));
  mvps_send_raw(g_server, conn_id, buf.data(), (long long)buf.size());
}

int listen_and_adopt(void* srv, int* port_out) {
  int lfd = socket(AF_INET, SOCK_STREAM, 0);
  assert(lfd >= 0);
  int one = 1;
  setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in a = {};
  a.sin_family = AF_INET;
  a.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  a.sin_port = 0;
  assert(bind(lfd, (sockaddr*)&a, sizeof(a)) == 0);
  assert(listen(lfd, 16) == 0);
  socklen_t alen = sizeof(a);
  assert(getsockname(lfd, (sockaddr*)&a, &alen) == 0);
  *port_out = ntohs(a.sin_port);
  std::thread([srv, lfd] {
    for (;;) {
      int fd = accept(lfd, nullptr, nullptr);
      if (fd < 0) return;
      if (mvps_server_adopt(srv, fd) != 0) return;
    }
  }).detach();
  return lfd;
}

}  // namespace

int main() {
  const long long N = 64, C = 8;
  std::vector<float> shard_data((N + 1) * C, 0.f);
  std::vector<uint8_t> dirty(2 * N, 0);

  g_server = mvps_server_new(punt_cb, /*rank=*/0);
  void* pin = mvps_register_shard(g_server, "t", /*lo=*/0, N, C,
                                  /*itemsize=*/4, /*sign=*/1.0,
                                  shard_data.data(), dirty.data(),
                                  /*nworkers=*/2);
  assert(pin);
  int port = 0;
  int lfd = listen_and_adopt(g_server, &port);

  void* c1 = mvnet_connect("127.0.0.1", port, 5.0, 10.0);
  void* c2 = mvnet_connect("127.0.0.1", port, 5.0, 10.0);
  assert(c1 && c2);

  const char* meta = "{\"table\": \"t\"}";
  int64_t ids[4] = {1, 5, 9, 13};
  int64_t ids_mixed[4] = {1, 2, 5, 8};   // both mod-2 owners
  float vals[4 * C];
  for (int i = 0; i < 4 * C; ++i) vals[i] = 1.0f;
  int64_t vshape[2] = {4, C};

  // plain counted add + wait
  long long seq = 0;
  long long mid = mvnet_add(c1, 0x11, meta, strlen(meta), ids, 4, vals,
                            sizeof(vals), "<f4", vshape, 2, &seq);
  assert(mid >= 0 && seq == 1);
  assert(mvnet_wait_adds(c1, seq, 10.0) == 0);
  char ebuf[128];
  assert(mvnet_take_add_error(c1, mid, ebuf, sizeof(ebuf)) == 0);
  assert(mvnet_adds_done(c1) == 1 && mvnet_adds_issued(c1) == 1);

  // add fanout (world=2 routing: id % 2 -> two "ranks", both mapping to
  // the same server here via conns[])
  void* conns[2] = {c1, c2};
  long long oseq[2], omid[2];
  int nr = mvnet_add_fanout(conns, 2, /*mod_owner=*/1, /*rows_per=*/0,
                            meta, strlen(meta), ids_mixed, 4, vals,
                            C * sizeof(float), "<f4", C, oseq, omid);
  assert(nr == 2 && omid[0] >= 0 && omid[1] >= 0);
  assert(mvnet_wait_adds(c1, oseq[0], 10.0) == 0);
  assert(mvnet_wait_adds(c2, oseq[1], 10.0) == 0);

  // scatter get fanout: rows {1,5} saw both adds (2.0), {2,8} one (1.0)
  float out[4 * C] = {0};
  long long gmid[2];
  nr = mvnet_get_fanout(conns, 2, 1, 0, meta, strlen(meta), ids_mixed, 4,
                        out, C * sizeof(float), gmid);
  assert(nr == 2);
  for (int r = 0; r < 2; ++r)
    assert(mvnet_get_wait(conns[r], gmid[r], 10.0) == 0);
  const float want[4] = {2.0f, 1.0f, 2.0f, 1.0f};
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < C; ++j) assert(out[i * C + j] == want[i]);
  for (int i = 0; i < 4; ++i)
    assert(dirty[ids_mixed[i]] == 1 && dirty[N + ids_mixed[i]] == 1);

  // full get
  std::vector<float> full(N * C);
  long long fmid = mvnet_get_send(c1, 0x15, meta, strlen(meta), nullptr, 0,
                                  full.data(),
                                  (long long)(full.size() * 4));
  assert(fmid >= 0 && mvnet_get_wait(c1, fmid, 10.0) == 0);
  assert(full[1 * C] == 2.0f && full[9 * C] == 1.0f && full[0] == 0.0f);

  // error reply (out-of-shard id) keeps the connection usable
  int64_t bad = N + 7;
  float tiny[C];
  long long bmid = mvnet_get_send(c1, 0x12, meta, strlen(meta), &bad, 1,
                                  tiny, sizeof(tiny));
  assert(bmid >= 0 && mvnet_get_wait(c1, bmid, 10.0) == -2);
  char err[256];
  mvnet_last_error(c1, err, sizeof(err));
  assert(strstr(err, "outside shard"));

  // punted message (unknown table) -> ERR reply via mvps_send_raw
  const char* pmeta = "{\"table\": \"nope\", \"weird\": 1}";
  long long pmid = mvnet_get_send(c1, 0x12, pmeta, strlen(pmeta), ids, 1,
                                  tiny, sizeof(tiny));
  assert(pmid >= 0 && mvnet_get_wait(c1, pmid, 10.0) == -2);
  assert(g_punts.load() == 1);

  // concurrent adds on ONE conn: seq assignment and the wire write share
  // a wmu hold (mvnet_add), so replies arrive in seq order and the
  // counted fence is exact — TSan sees the locking, the asserts see the
  // accounting (4 threads x 8 adds, all acked, no errors recorded)
  {
    long long before = mvnet_adds_done(c1);
    std::vector<std::thread> adders;
    std::vector<long long> mids(4 * 8);
    for (int t = 0; t < 4; ++t)
      adders.emplace_back([&, t] {
        for (int i = 0; i < 8; ++i) {
          long long s = 0;
          mids[t * 8 + i] = mvnet_add(c1, 0x11, meta, strlen(meta), ids,
                                      4, vals, sizeof(vals), "<f4",
                                      vshape, 2, &s);
          assert(mids[t * 8 + i] >= 0 && s > 0);
        }
      });
    for (auto& th : adders) th.join();
    assert(mvnet_wait_adds(c1, mvnet_adds_issued(c1), 10.0) == 0);
    assert(mvnet_adds_done(c1) == before + 4 * 8);
    for (long long m : mids)
      assert(mvnet_take_add_error(c1, m, ebuf, sizeof(ebuf)) == 0);
  }

  // cancelled get: recv thread must never touch the buffer afterwards
  long long cmid = mvnet_get_send(c2, 0x15, meta, strlen(meta), nullptr, 0,
                                  full.data(),
                                  (long long)(full.size() * 4));
  mvnet_get_cancel(c2, cmid);

  // pin lock/stats from this thread while conn threads are live
  mvps_shard_pin_lock(pin);
  mvps_shard_pin_unlock(pin);
  unsigned long long adds = 0, applies = 0;
  mvps_shard_pin_stats(pin, &adds, &applies);
  // 1 single + 2 fanout legs + 32 hammer adds
  assert(adds == 35 && applies == 35);

  // hard drop with an add outstanding: futures must observe dead
  long long dseq = 0;
  mvnet_add(c2, 0x11, meta, strlen(meta), ids, 4, vals, sizeof(vals),
            "<f4", vshape, 2, &dseq);
  mvnet_shutdown(c2);
  assert(mvnet_dead(c2) == 1);
  int rc = mvnet_wait_adds(c2, dseq + 999, 1.0);
  assert(rc == -3 || rc == 0);  // dead, or acked before the shutdown won

  mvnet_free(c2);
  mvnet_shutdown(c1);
  mvnet_free(c1);
  close(lfd);
  mvps_server_free(g_server);
  mvps_shard_pin_free(pin);
  printf("mv_ps_smoke OK (punts=%d)\n", g_punts.load());
  return 0;
}
