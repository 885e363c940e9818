// HTTP/2 gRPC load generator of the benchmark: Envoy's ext_authz Check()
// over loopback, closed loop, every answer kept for the judge.
//
// Grown from the port's own closed-loop generator: each CheckRequest is
// baked once into HEADERS+DATA frame bytes (HPACK literals without
// indexing, so the block is stream-independent and only the stream ids
// are patched) and N connections are driven from one thread.
//
// Each connection keeps <depth> streams in flight.
//
// Payloads are sent in file order, cycled.  Every stream's answer is
// tallied per payload: its DATA message bytes (or how it ended without
// one), how often that exact answer came, how many of those completed
// inside the measured window and how many were sent inside it.  After the
// window no new request is sent and the generator waits up to <drain>
// seconds for the streams still in flight.
//
// Usage: loadgen --port P --payloads FILE --seconds S --warmup W
//                --conns C --depth D --tally FILE [--drain S] [--host H]
//   payloads: repeated [u32 big-endian length][CheckRequest bytes]
//   tally: per answer variant [u32 payload][u32 kind][u32 total]
//     [u32 done in window][u32 due in window][u32 length][bytes],
//     little-endian; kind 0 a message, 1 ended without one, 2 reset.
// Prints "WINDOW_START <t>" and "WINDOW_END <t>" on stderr as they pass
// (CLOCK_MONOTONIC seconds) and one JSON line on stdout at the end, with
// the answers completed in each second of the window.

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <math.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <signal.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/socket.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <string>
#include <unordered_map>
#include <vector>

static double now_s() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

static void be24(std::string& s, uint32_t v) {
  s.push_back((char)(v >> 16));
  s.push_back((char)(v >> 8));
  s.push_back((char)v);
}

static void be32(std::string& s, uint32_t v) {
  s.push_back((char)(v >> 24));
  s.push_back((char)(v >> 16));
  s.push_back((char)(v >> 8));
  s.push_back((char)v);
}

// one request's frames with the two stream-id offsets to patch
struct Baked {
  std::string bytes;
  size_t sid_off1, sid_off2;
};

static Baked bake(const std::string& msg) {
  std::string hp;
  hp.push_back((char)0x83);  // :method POST (static 3)
  hp.push_back((char)0x86);  // :scheme http (static 6)
  static const char kPath[] = "/envoy.service.auth.v3.Authorization/Check";
  hp.push_back((char)0x04);  // literal w/o indexing, name = static 4 (:path)
  hp.push_back((char)(sizeof(kPath) - 1));
  hp.append(kPath, sizeof(kPath) - 1);
  hp.push_back((char)0x01);  // :authority (static 1)
  hp.push_back((char)2);
  hp.append("lg", 2);
  hp.push_back((char)0x0f);  // content-type (static 31 = 15 + 16)
  hp.push_back((char)0x10);
  hp.push_back((char)16);
  hp.append("application/grpc", 16);
  hp.push_back((char)0x00);  // te: trailers (new name)
  hp.push_back((char)2);
  hp.append("te", 2);
  hp.push_back((char)8);
  hp.append("trailers", 8);

  Baked b;
  be24(b.bytes, (uint32_t)hp.size());
  b.bytes.push_back((char)0x01);  // HEADERS
  b.bytes.push_back((char)0x04);  // END_HEADERS
  b.sid_off1 = b.bytes.size();
  be32(b.bytes, 0);
  b.bytes.append(hp);
  uint32_t dlen = 5 + (uint32_t)msg.size();
  be24(b.bytes, dlen);
  b.bytes.push_back((char)0x00);  // DATA
  b.bytes.push_back((char)0x01);  // END_STREAM
  b.sid_off2 = b.bytes.size();
  be32(b.bytes, 0);
  b.bytes.push_back((char)0);     // uncompressed
  be32(b.bytes, (uint32_t)msg.size());
  b.bytes.append(msg);
  return b;
}

// ---- the tally ------------------------------------------------------------

enum Kind : uint32_t { kMessage = 0, kNoMessage = 1, kReset = 2 };

struct Variant {
  uint64_t hash;
  uint32_t kind;
  uint32_t total = 0, done_in_window = 0, due_in_window = 0;
  uint32_t id;
  std::string bytes;
};

static const size_t kMaxVariants = 8;
static std::vector<std::vector<Variant>> g_tally;  // per payload
static std::vector<std::pair<uint32_t, uint32_t>> g_variant_at;  // id -> (payload, slot)
static uint64_t g_variant_overflow = 0;

static uint64_t fnv1a(uint32_t kind, const std::string& s) {
  uint64_t h = 1469598103934665603ULL ^ kind;
  for (unsigned char c : s) {
    h ^= c;
    h *= 1099511628211ULL;
  }
  return h;
}

// the variant id of this answer of payload p (0xffffffff past the cap)
static uint32_t tally(uint32_t p, uint32_t kind, const std::string& bytes,
                      bool done_in_window, bool due_in_window) {
  uint64_t h = fnv1a(kind, bytes);
  std::vector<Variant>& vs = g_tally[p];
  Variant* v = nullptr;
  for (Variant& x : vs)
    if (x.hash == h && x.kind == kind && x.bytes.size() == bytes.size()) {
      v = &x;
      break;
    }
  if (!v) {
    if (vs.size() >= kMaxVariants) {
      g_variant_overflow++;
      return 0xffffffffu;
    }
    Variant nv;
    nv.hash = h;
    nv.kind = kind;
    nv.bytes = bytes;
    nv.id = (uint32_t)g_variant_at.size();
    g_variant_at.push_back({p, (uint32_t)vs.size()});
    vs.push_back(nv);
    v = &vs.back();
  }
  v->total++;
  if (done_in_window) v->done_in_window++;
  if (due_in_window) v->due_in_window++;
  return v->id;
}

// ---- connections ----------------------------------------------------------

struct Stream {
  uint32_t payload;
  bool due_in_window;  // sent inside the window
  std::string data;   // DATA payload so far
};

struct ConnSt {
  int fd = -1;
  std::string out;
  size_t out_off = 0;
  uint8_t hdr[9];
  int hdr_got = 0;
  uint32_t frame_len = 0;
  uint8_t frame_type = 0, frame_flags = 0;
  int32_t frame_sid = 0;
  uint32_t payload_left = 0;
  std::string payload;  // the current frame's payload, when kept
  bool keep_payload = false;
  int32_t next_sid = 1;
  int in_flight = 0;
  std::unordered_map<int32_t, Stream> streams;
  bool dead = false;
};

static double g_ws = 1e300, g_we = 1e300;  // the window, once known
static uint64_t g_done_window = 0, g_answered = 0;
static std::vector<uint32_t> g_done_per_s;  // completions per window second

static void finish(ConnSt& c, int32_t sid, uint32_t kind) {
  auto it = c.streams.find(sid);
  if (it == c.streams.end()) return;
  Stream& s = it->second;
  double t = now_s();
  bool done_in_window = t >= g_ws && t < g_we;
  std::string bytes;
  if (kind == kMessage) {
    if (s.data.size() >= 5)
      bytes = s.data.substr(5);
    else
      kind = kNoMessage;
  }
  tally(s.payload, kind, bytes, done_in_window, s.due_in_window);
  g_answered++;
  if (done_in_window) {
    g_done_window++;
    size_t sec = (size_t)(t - g_ws);
    if (sec < g_done_per_s.size()) g_done_per_s[sec]++;
  }
  c.streams.erase(it);
  c.in_flight--;
}

static void handle_frame(ConnSt& c) {
  switch (c.frame_type) {
    case 0x04:  // SETTINGS
      if (!(c.frame_flags & 0x01)) {
        static const char ack[] = {0, 0, 0, 0x04, 0x01, 0, 0, 0, 0};
        c.out.append(ack, 9);
      }
      break;
    case 0x06:  // PING
      if (!(c.frame_flags & 0x01) && c.payload.size() == 8) {
        std::string f;
        be24(f, 8);
        f.push_back((char)0x06);
        f.push_back((char)0x01);
        be32(f, 0);
        f.append(c.payload);
        c.out.append(f);
      }
      break;
    case 0x00: {  // DATA
      auto it = c.streams.find(c.frame_sid);
      if (it != c.streams.end()) {
        const std::string& p = c.payload;
        size_t off = 0, end = p.size();
        if ((c.frame_flags & 0x08) && !p.empty()) {  // PADDED
          off = 1;
          end = p.size() > (size_t)(uint8_t)p[0] + 1 ? p.size() - (uint8_t)p[0] : 1;
        }
        it->second.data.append(p, off, end - off);
      }
      if (c.frame_flags & 0x01) finish(c, c.frame_sid, kMessage);
      break;
    }
    case 0x01:  // HEADERS (response headers or trailers)
      if (c.frame_flags & 0x01) finish(c, c.frame_sid, kMessage);
      break;
    case 0x03:  // RST_STREAM
      finish(c, c.frame_sid, kReset);
      break;
    case 0x07:  // GOAWAY
      c.dead = true;
      break;
    default:
      break;
  }
}

static void feed(ConnSt& c, const uint8_t* p, size_t n) {
  while (n) {
    if (c.payload_left) {
      size_t take = n < c.payload_left ? n : c.payload_left;
      if (c.keep_payload) c.payload.append((const char*)p, take);
      c.payload_left -= (uint32_t)take;
      p += take;
      n -= take;
      if (c.payload_left == 0) handle_frame(c);
      continue;
    }
    size_t need = 9 - c.hdr_got;
    size_t take = n < need ? n : need;
    memcpy(c.hdr + c.hdr_got, p, take);
    c.hdr_got += (int)take;
    p += take;
    n -= take;
    if (c.hdr_got < 9) return;
    c.hdr_got = 0;
    c.frame_len = ((uint32_t)c.hdr[0] << 16) | ((uint32_t)c.hdr[1] << 8) | c.hdr[2];
    c.frame_type = c.hdr[3];
    c.frame_flags = c.hdr[4];
    c.frame_sid = (int32_t)(((uint32_t)c.hdr[5] << 24) | ((uint32_t)c.hdr[6] << 16) |
                            ((uint32_t)c.hdr[7] << 8) | c.hdr[8]) & 0x7fffffff;
    c.payload.clear();
    c.keep_payload = c.frame_type == 0x04 || c.frame_type == 0x06 || c.frame_type == 0x00;
    c.payload_left = c.frame_len;
    if (c.payload_left == 0) handle_frame(c);
  }
}

static void send_one(ConnSt& c, const Baked& b, uint32_t payload,
                     bool due_in_window) {
  size_t base = c.out.size();
  c.out.append(b.bytes);
  uint32_t sid = (uint32_t)c.next_sid;
  uint8_t* p1 = (uint8_t*)&c.out[base + b.sid_off1];
  uint8_t* p2 = (uint8_t*)&c.out[base + b.sid_off2];
  p1[0] = (uint8_t)(sid >> 24); p1[1] = (uint8_t)(sid >> 16);
  p1[2] = (uint8_t)(sid >> 8);  p1[3] = (uint8_t)sid;
  p2[0] = (uint8_t)(sid >> 24); p2[1] = (uint8_t)(sid >> 16);
  p2[2] = (uint8_t)(sid >> 8);  p2[3] = (uint8_t)sid;
  Stream s;
  s.payload = payload;
  s.due_in_window = due_in_window;
  c.streams.emplace((int32_t)sid, std::move(s));
  c.next_sid += 2;
  c.in_flight++;
}

static const char* arg(int argc, char** argv, const char* name, const char* dflt) {
  for (int i = 1; i + 1 < argc; ++i)
    if (!strcmp(argv[i], name)) return argv[i + 1];
  return dflt;
}

int main(int argc, char** argv) {
  signal(SIGPIPE, SIG_IGN);
  const char* host = arg(argc, argv, "--host", "127.0.0.1");
  int port = atoi(arg(argc, argv, "--port", "0"));
  const char* payload_path = arg(argc, argv, "--payloads", nullptr);
  const char* tally_path = arg(argc, argv, "--tally", nullptr);
  double seconds = atof(arg(argc, argv, "--seconds", "0"));
  double warmup = atof(arg(argc, argv, "--warmup", "0"));
  double drain = atof(arg(argc, argv, "--drain", "60"));
  int nconns = atoi(arg(argc, argv, "--conns", "1"));
  int depth = atoi(arg(argc, argv, "--depth", "0"));
  if (!port || !payload_path || !tally_path || seconds <= 0 || nconns < 1 ||
      depth < 1) {
    fprintf(stderr,
            "usage: loadgen --port P --payloads F --seconds S --warmup W --conns C "
            "--depth D --tally F [--drain S] [--host H]\n");
    return 2;
  }

  std::vector<Baked> baked;
  {
    FILE* f = fopen(payload_path, "rb");
    if (!f) { perror("payloads"); return 2; }
    for (;;) {
      uint8_t lb[4];
      if (fread(lb, 1, 4, f) != 4) break;
      uint32_t len = ((uint32_t)lb[0] << 24) | ((uint32_t)lb[1] << 16) |
                     ((uint32_t)lb[2] << 8) | lb[3];
      std::string msg(len, '\0');
      if (len && fread(&msg[0], 1, len, f) != len) break;
      baked.push_back(bake(msg));
    }
    fclose(f);
  }
  if (baked.empty()) { fprintf(stderr, "no payloads\n"); return 2; }
  g_tally.resize(baked.size());

  std::vector<ConnSt> conns((size_t)nconns);
  for (ConnSt& c : conns) {
    c.fd = socket(AF_INET, SOCK_STREAM, 0);
    struct sockaddr_in addr;
    memset(&addr, 0, sizeof addr);
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)port);
    inet_pton(AF_INET, host, &addr.sin_addr);
    if (connect(c.fd, (struct sockaddr*)&addr, sizeof addr) < 0) {
      perror("connect");
      return 2;
    }
    int one = 1;
    setsockopt(c.fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    fcntl(c.fd, F_SETFL, O_NONBLOCK);
    c.out = "PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n";
    // SETTINGS: a huge initial window and stream limit, then a huge
    // connection WINDOW_UPDATE: the answers are small, so client-side
    // flow control never holds them
    std::string st;
    be24(st, 12);
    st.push_back((char)0x04);
    st.push_back((char)0x00);
    be32(st, 0);
    st.push_back(0); st.push_back(0x04); be32(st, 0x7fffffff);
    st.push_back(0); st.push_back(0x03); be32(st, 0x7fffffff);
    c.out.append(st);
    std::string wu;
    be24(wu, 4);
    wu.push_back((char)0x08);
    wu.push_back((char)0x00);
    be32(wu, 0);
    be32(wu, 0x7fffffff - 65535);
    c.out.append(wu);
  }

  size_t pay_i = 0;
  double t_start = now_s();
  double t_measure = t_start + warmup;
  double t_end = t_measure + seconds;
  double t_quit = 1e300;
  bool recording = false, closed = false;
  uint64_t sent = 0, attempted = 0;

  std::vector<struct pollfd> pfds((size_t)nconns);
  static uint8_t buf[262144];
  for (;;) {
    double now = now_s();
    if (!recording && now >= t_measure) {
      recording = true;
      g_ws = t_measure = now;
      g_we = t_end = now + seconds;
      g_done_per_s.assign((size_t)ceil(seconds), 0);
      fprintf(stderr, "WINDOW_START %.6f\n", now);
      fflush(stderr);
    }
    if (!closed && now >= t_end) {
      closed = true;
      t_quit = now + drain;
      fprintf(stderr, "WINDOW_END %.6f\n", now);
      fflush(stderr);
    }
    if (closed) {
      int live = 0;
      for (ConnSt& c : conns)
        if (!c.dead) live += c.in_flight;
      if (live == 0 || now >= t_quit) break;
    }

    if (!closed) {
      for (ConnSt& c : conns) {
        if (c.dead) continue;
        while (c.in_flight < depth && c.next_sid < 0x7ffffff0 &&
               c.out.size() - c.out_off < (size_t)4 << 20) {
          uint32_t p = (uint32_t)(pay_i++ % baked.size());
          bool in_win = recording;
          send_one(c, baked[p], p, in_win);
          sent++;
          if (in_win) attempted++;
        }
      }
    }

    for (int i = 0; i < nconns; ++i) {
      pfds[i].fd = conns[i].dead ? -1 : conns[i].fd;
      pfds[i].events = POLLIN;
      if (conns[i].out_off < conns[i].out.size()) pfds[i].events |= POLLOUT;
    }
    double wait = 0.010;
    if (!recording) wait = std::min(wait, std::max(0.0, t_measure - now_s()));
    struct timespec ts;
    ts.tv_sec = 0;
    ts.tv_nsec = (long)(wait * 1e9);
    ppoll(pfds.data(), (nfds_t)nconns, &ts, nullptr);
    for (int i = 0; i < nconns; ++i) {
      ConnSt& c = conns[i];
      if (c.dead) continue;
      if (pfds[i].revents & POLLOUT) {
        ssize_t w = send(c.fd, c.out.data() + c.out_off, c.out.size() - c.out_off,
                         MSG_NOSIGNAL);
        if (w > 0) {
          c.out_off += (size_t)w;
          if (c.out_off == c.out.size()) {
            c.out.clear();
            c.out_off = 0;
          } else if (c.out_off > (size_t)1 << 20) {
            c.out.erase(0, c.out_off);
            c.out_off = 0;
          }
        } else if (w < 0 && errno != EAGAIN && errno != EWOULDBLOCK) {
          c.dead = true;
        }
      }
      if (pfds[i].revents & (POLLIN | POLLHUP | POLLERR)) {
        for (;;) {
          ssize_t r = recv(c.fd, buf, sizeof buf, 0);
          if (r > 0) {
            feed(c, buf, (size_t)r);
            if (r < (ssize_t)sizeof buf) break;
          } else if (r == 0) {
            c.dead = true;
            break;
          } else {
            if (errno != EAGAIN && errno != EWOULDBLOCK) c.dead = true;
            break;
          }
        }
      }
    }
  }

  uint64_t unanswered = 0, unanswered_due_in_window = 0, dead = 0;
  for (ConnSt& c : conns) {
    dead += c.dead;
    for (auto& kv : c.streams) {
      unanswered++;
      if (kv.second.due_in_window) unanswered_due_in_window++;
    }
    close(c.fd);
  }

  FILE* t = fopen(tally_path, "wb");
  if (!t) { perror("tally"); return 2; }
  for (auto& at : g_variant_at) {
    const Variant& v = g_tally[at.first][at.second];
    uint32_t rec[6] = {at.first, v.kind, v.total, v.done_in_window,
                       v.due_in_window, (uint32_t)v.bytes.size()};
    fwrite(rec, sizeof rec, 1, t);
    fwrite(v.bytes.data(), 1, v.bytes.size(), t);
  }
  fclose(t);

  std::string per_s;
  for (size_t i = 0; i < g_done_per_s.size(); ++i)
    per_s += (i ? ", " : "") + std::to_string(g_done_per_s[i]);
  printf(
      "{\"conns\": %d, \"depth\": %d, "
      "\"payloads\": %zu, \"window_start\": %.6f, \"window_end\": %.6f, "
      "\"window_s\": %.6f, \"sent\": %llu, \"attempted\": %llu, "
      "\"answered\": %llu, \"done_in_window\": %llu, \"unanswered\": %llu, "
      "\"unanswered_due_in_window\": %llu, \"dead_conns\": %llu, "
      "\"variants\": %zu, \"variant_overflow\": %llu, \"done_per_s\": [%s]}\n",
      nconns, depth, baked.size(), g_ws, g_we,
      g_we - g_ws, (unsigned long long)sent, (unsigned long long)attempted,
      (unsigned long long)g_answered, (unsigned long long)g_done_window,
      (unsigned long long)unanswered, (unsigned long long)unanswered_due_in_window,
      (unsigned long long)dead, g_variant_at.size(),
      (unsigned long long)g_variant_overflow, per_s.c_str());
  return 0;
}
