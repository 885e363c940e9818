// Minimal HTTP/2 gRPC load generator for the native ext_authz frontend.
//
// Prebakes each CheckRequest payload into HEADERS+DATA frame bytes once
// (HPACK literals without indexing → the block is stream-independent, only
// the stream ids get patched), then drives N connections with D concurrent
// streams each from one thread.  Latency is measured per stream from
// enqueue to the grpc trailers frame — the number a real client sees.
//
// The server side is the full nghttp2 stack; this client stays raw on
// purpose: on the 1-core benchmark host, client cycles eat directly into
// the measured server throughput, so the client must be as thin as the
// wire allows (the reference benchmarks pay the same tax in-process via
// go test -bench, ref Makefile:135-142).
//
// Usage: loadgen <host> <port> <payload_file> <seconds> <warmup_s> <depth> <conns>
//   payload_file: repeated [u32 big-endian length][CheckRequest bytes]
// Prints one JSON line on stdout.

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
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
  // HPACK block: literals without indexing, no huffman
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
  // HEADERS frame
  be24(b.bytes, (uint32_t)hp.size());
  b.bytes.push_back((char)0x01);  // type HEADERS
  b.bytes.push_back((char)0x04);  // END_HEADERS
  b.sid_off1 = b.bytes.size();
  be32(b.bytes, 0);
  b.bytes.append(hp);
  // DATA frame: 5-byte gRPC prefix + message, END_STREAM
  uint32_t dlen = 5 + (uint32_t)msg.size();
  be24(b.bytes, dlen);
  b.bytes.push_back((char)0x00);  // type DATA
  b.bytes.push_back((char)0x01);  // END_STREAM
  b.sid_off2 = b.bytes.size();
  be32(b.bytes, 0);
  b.bytes.push_back((char)0);     // uncompressed
  be32(b.bytes, (uint32_t)msg.size());
  b.bytes.append(msg);
  return b;
}

struct ConnSt {
  int fd = -1;
  std::string out;
  size_t out_off = 0;
  // reader state machine
  uint8_t hdr[9];
  int hdr_got = 0;
  uint32_t frame_len = 0;
  uint8_t frame_type = 0, frame_flags = 0;
  int32_t frame_sid = 0;
  uint32_t payload_left = 0;
  std::vector<uint8_t> payload;  // kept only for SETTINGS/PING
  bool collect_payload = false;
  int32_t next_sid = 1;
  int in_flight = 0;
  std::unordered_map<int32_t, double> t0;
  bool dead = false;
};

static uint64_t g_done = 0, g_errors = 0;
static std::vector<float>* g_lat = nullptr;
static bool g_record = false;

static void stream_done(ConnSt& c, int32_t sid, bool ok) {
  auto it = c.t0.find(sid);
  if (it != c.t0.end()) {
    if (g_record && g_lat) g_lat->push_back((float)((now_s() - it->second) * 1e3));
    c.t0.erase(it);
    c.in_flight--;
    if (g_record) {
      g_done++;
      if (!ok) g_errors++;
    }
  }
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
        f.append((const char*)c.payload.data(), 8);
        c.out.append(f);
      }
      break;
    case 0x01:  // HEADERS (response or trailers)
      if (c.frame_flags & 0x01) stream_done(c, c.frame_sid, true);
      break;
    case 0x00:  // DATA
      if (c.frame_flags & 0x01) stream_done(c, c.frame_sid, true);
      break;
    case 0x03:  // RST_STREAM
      stream_done(c, c.frame_sid, false);
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
      if (c.collect_payload) c.payload.insert(c.payload.end(), p, p + take);
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
    c.collect_payload = (c.frame_type == 0x04 || c.frame_type == 0x06);
    c.payload_left = c.frame_len;
    if (c.payload_left == 0) handle_frame(c);
  }
}

int main(int argc, char** argv) {
  if (argc < 8) {
    fprintf(stderr,
            "usage: loadgen <host> <port> <payloads> <seconds> <warmup> <depth> <conns>\n");
    return 2;
  }
  const char* host = argv[1];
  int port = atoi(argv[2]);
  FILE* f = fopen(argv[3], "rb");
  if (!f) { perror("payloads"); return 2; }
  double seconds = atof(argv[4]);
  double warmup = atof(argv[5]);
  int depth = atoi(argv[6]);
  int nconns = atoi(argv[7]);

  std::vector<Baked> baked;
  for (;;) {
    uint8_t lb[4];
    if (fread(lb, 1, 4, f) != 4) break;
    uint32_t len = ((uint32_t)lb[0] << 24) | ((uint32_t)lb[1] << 16) |
                   ((uint32_t)lb[2] << 8) | lb[3];
    std::string msg(len, '\0');
    if (fread(&msg[0], 1, len, f) != len) break;
    baked.push_back(bake(msg));
  }
  fclose(f);
  if (baked.empty()) { fprintf(stderr, "no payloads\n"); return 2; }

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
    // SETTINGS: huge initial window, then a huge connection WINDOW_UPDATE —
    // flow control effectively disabled client-side (responses are tiny)
    std::string st;
    be24(st, 12);
    st.push_back((char)0x04);
    st.push_back((char)0x00);
    be32(st, 0);
    st.push_back(0); st.push_back(0x04); be32(st, 0x7fffffff);  // INITIAL_WINDOW_SIZE
    st.push_back(0); st.push_back(0x03); be32(st, 0x7fffffff);  // MAX_CONCURRENT_STREAMS
    c.out.append(st);
    std::string wu;
    be24(wu, 4);
    wu.push_back((char)0x08);
    wu.push_back((char)0x00);
    be32(wu, 0);
    be32(wu, 0x7fffffff - 65535);
    c.out.append(wu);
  }

  std::vector<float> lat;
  lat.reserve(1 << 22);
  g_lat = &lat;

  size_t pay_i = 0;
  double t_start = now_s();
  double t_measure = t_start + warmup;
  double t_end = t_measure + seconds;
  bool recording = false;
  uint64_t launched = 0;

  std::vector<struct pollfd> pfds((size_t)nconns);
  uint8_t buf[262144];
  for (;;) {
    double now = now_s();
    if (!recording && now >= t_measure) {
      recording = true;
      g_record = true;
      g_done = 0;
      g_errors = 0;
      lat.clear();
      t_measure = now;  // actual start of the measured window
    }
    if (now >= t_end) break;

    // top up each connection's pipeline
    for (ConnSt& c : conns) {
      if (c.dead) continue;
      while (c.in_flight < depth && c.next_sid < 0x7ffffff0 &&
             c.out.size() - c.out_off < (size_t)4 << 20) {
        const Baked& b = baked[pay_i++ % baked.size()];
        size_t base = c.out.size();
        c.out.append(b.bytes);
        uint32_t sid = (uint32_t)c.next_sid;
        uint8_t* p1 = (uint8_t*)&c.out[base + b.sid_off1];
        uint8_t* p2 = (uint8_t*)&c.out[base + b.sid_off2];
        p1[0] = (uint8_t)(sid >> 24); p1[1] = (uint8_t)(sid >> 16);
        p1[2] = (uint8_t)(sid >> 8);  p1[3] = (uint8_t)sid;
        p2[0] = (uint8_t)(sid >> 24); p2[1] = (uint8_t)(sid >> 16);
        p2[2] = (uint8_t)(sid >> 8);  p2[3] = (uint8_t)sid;
        c.t0[(int32_t)sid] = now_s();
        c.next_sid += 2;
        c.in_flight++;
        launched++;
      }
    }

    for (int i = 0; i < nconns; ++i) {
      pfds[i].fd = conns[i].fd;
      pfds[i].events = POLLIN;
      if (conns[i].out_off < conns[i].out.size()) pfds[i].events |= POLLOUT;
    }
    poll(pfds.data(), (nfds_t)nconns, 10);
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
      if (pfds[i].revents & (POLLIN | POLLHUP)) {
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
  double elapsed = now_s() - t_measure;
  for (ConnSt& c : conns) close(c.fd);

  std::sort(lat.begin(), lat.end());
  auto pct = [&](double q) {
    if (lat.empty()) return 0.0;
    size_t i = (size_t)(q * (lat.size() - 1));
    return (double)lat[i];
  };
  printf(
      "{\"total\": %llu, \"seconds\": %.3f, \"rps\": %.1f, \"p50_ms\": %.3f, "
      "\"p90_ms\": %.3f, \"p99_ms\": %.3f, \"errors\": %llu, \"conns\": %d, "
      "\"depth\": %d}\n",
      (unsigned long long)g_done, elapsed, g_done / elapsed, pct(0.5), pct(0.9),
      pct(0.99), (unsigned long long)g_errors, nconns, depth);
  return 0;
}
