// Native runtime support for laser_slam_tpu.
//
// TPU-native framework still needs a real host runtime: fast log
// parsing, a producer/consumer scan queue between sensor threads and
// the device feed, a TCP scan-frame transport for the distributed
// frontend/backend split, and the SICK CoLa-A telegram codec. The
// reference implements these with Qt threads + QTcpSocket framing
// (src/tcp_slam/serverSocket.cpp:58-116), pthreads in the SICK driver
// (src/sick_reader/CSICK.cpp:101-311), and C++ log readers
// (src/zhpsm/ZHPolar_Match.cpp:172-330). This library provides the
// equivalents behind a plain C ABI consumed via ctypes.
//
// Build: g++ -O2 -shared -fPIC -pthread native.cpp -o libnative.so

#include <arpa/inet.h>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <pthread.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// CARMEN log parser
// ---------------------------------------------------------------------------

typedef struct {
  int n_scans;
  int n_beams;       // beams per scan (padded)
  float* ranges;     // [n_scans * n_beams]
  float* poses;      // [n_scans * 3] laser pose from the record
  double* stamps;    // [n_scans]
  int n_gt;
  float* gt;         // [n_gt * 3] VERTEX2 ground truth
  float start_rad;   // bearing of beam 0
  float fov_rad;
  float max_range;
} CarmenData;

static int pad_beam_count(int n) {
  // Match the Python reader: 180->181, 360->361, 540->541.
  const int presets[] = {181, 361, 541};
  for (int p : presets)
    if (n == p || n == p - 1) return p;
  return n;
}

CarmenData* carmen_parse(const char* path, int max_scans) {
  FILE* f = fopen(path, "r");
  if (!f) return nullptr;
  auto* out = new CarmenData();
  std::vector<float> ranges, poses, gt;
  std::vector<double> stamps;
  int n_beams = 0;
  float start = 0, fov = 0, maxr = 0;
  bool first = true;

  char* line = nullptr;
  size_t cap = 0;
  ssize_t len;
  std::vector<char*> tok;
  while ((len = getline(&line, &cap, f)) > 0) {
    if (strncmp(line, "VERTEX2 ", 8) == 0) {
      float x, y, th;
      int id;
      if (sscanf(line + 8, "%d %f %f %f", &id, &x, &y, &th) == 4) {
        gt.push_back(x); gt.push_back(y); gt.push_back(th);
      }
      continue;
    }
    if (strncmp(line, "ROBOTLASER1 ", 12) != 0) continue;
    tok.clear();
    for (char* p = strtok(line, " \t\n"); p; p = strtok(nullptr, " \t\n"))
      tok.push_back(p);
    if (tok.size() < 10) continue;
    int n = atoi(tok[8]);
    if (n <= 0 || (int)tok.size() < 9 + n + 1) continue;
    if (first) {
      first = false;
      start = atof(tok[2]);
      fov = atof(tok[3]);
      maxr = atof(tok[5]);
      n_beams = pad_beam_count(n);
    }
    float min_range = 0.10f;
    for (int i = 0; i < n_beams; i++) {
      float r = (i < n) ? (float)atof(tok[9 + i]) : maxr + 1.0f;
      if (r < min_range) r = maxr + 1.0f;
      ranges.push_back(r);
    }
    // rest: num_remissions [rem...] laser_x laser_y laser_th ... timestamp
    size_t k = 9 + n;
    int n_rem = (k < tok.size()) ? atoi(tok[k]) : 0;
    size_t pk = k + 1 + n_rem;
    float px = 0, py = 0, pth = 0;
    if (pk + 2 < tok.size()) {
      px = atof(tok[pk]); py = atof(tok[pk + 1]); pth = atof(tok[pk + 2]);
    }
    poses.push_back(px); poses.push_back(py); poses.push_back(pth);
    double ts = 0;
    if (pk + 11 < tok.size()) ts = atof(tok[pk + 11]);
    stamps.push_back(ts);
    if (max_scans > 0 && (int)stamps.size() >= max_scans) break;
  }
  free(line);
  fclose(f);

  out->n_scans = (int)stamps.size();
  out->n_beams = n_beams;
  out->start_rad = start;
  out->fov_rad = fov;
  out->max_range = maxr;
  out->ranges = (float*)malloc(ranges.size() * sizeof(float));
  memcpy(out->ranges, ranges.data(), ranges.size() * sizeof(float));
  out->poses = (float*)malloc(poses.size() * sizeof(float));
  memcpy(out->poses, poses.data(), poses.size() * sizeof(float));
  out->stamps = (double*)malloc(stamps.size() * sizeof(double));
  memcpy(out->stamps, stamps.data(), stamps.size() * sizeof(double));
  out->n_gt = (int)(gt.size() / 3);
  out->gt = (float*)malloc(gt.size() * sizeof(float));
  memcpy(out->gt, gt.data(), gt.size() * sizeof(float));
  return out;
}

void carmen_free(CarmenData* d) {
  if (!d) return;
  free(d->ranges); free(d->poses); free(d->stamps); free(d->gt);
  delete d;
}

// ---------------------------------------------------------------------------
// Scan ring buffer (mutex + condvar; the reference's mutex-guarded
// buffer-swap between Qt threads, threadLocal2.cpp:42-53)
// ---------------------------------------------------------------------------

typedef struct {
  int capacity;
  int max_beams;
  int head, tail, count;
  int dropped;
  float* ranges;   // [capacity * max_beams]
  float* poses;    // [capacity * 3]
  int* counts;     // [capacity]
  double* stamps;  // [capacity]
  pthread_mutex_t mu;
  pthread_cond_t cv;
} Ring;

void* ring_create(int capacity, int max_beams) {
  auto* r = new Ring();
  r->capacity = capacity;
  r->max_beams = max_beams;
  r->head = r->tail = r->count = r->dropped = 0;
  r->ranges = (float*)malloc((size_t)capacity * max_beams * sizeof(float));
  r->poses = (float*)malloc((size_t)capacity * 3 * sizeof(float));
  r->counts = (int*)malloc(capacity * sizeof(int));
  r->stamps = (double*)malloc(capacity * sizeof(double));
  pthread_mutex_init(&r->mu, nullptr);
  pthread_cond_init(&r->cv, nullptr);
  return r;
}

void ring_destroy(void* h) {
  auto* r = (Ring*)h;
  free(r->ranges); free(r->poses); free(r->counts); free(r->stamps);
  pthread_mutex_destroy(&r->mu);
  pthread_cond_destroy(&r->cv);
  delete r;
}

int ring_push(void* h, const float* ranges, int n, const float* pose,
              double stamp) {
  auto* r = (Ring*)h;
  if (n > r->max_beams) return -2;
  pthread_mutex_lock(&r->mu);
  if (r->count == r->capacity) {
    // Drop the oldest (sensor queues must not block the producer —
    // the reference drops stale scans the same way).
    r->tail = (r->tail + 1) % r->capacity;
    r->count--;
    r->dropped++;
  }
  int slot = r->head;
  memcpy(r->ranges + (size_t)slot * r->max_beams, ranges, n * sizeof(float));
  memcpy(r->poses + (size_t)slot * 3, pose, 3 * sizeof(float));
  r->counts[slot] = n;
  r->stamps[slot] = stamp;
  r->head = (r->head + 1) % r->capacity;
  r->count++;
  pthread_cond_signal(&r->cv);
  pthread_mutex_unlock(&r->mu);
  return 0;
}

int ring_pop(void* h, float* ranges, int* n, float* pose, double* stamp,
             int timeout_ms) {
  auto* r = (Ring*)h;
  pthread_mutex_lock(&r->mu);
  if (r->count == 0 && timeout_ms > 0) {
    struct timespec ts;
    struct timeval now;
    gettimeofday(&now, nullptr);
    long nsec = now.tv_usec * 1000L + (timeout_ms % 1000) * 1000000L;
    ts.tv_sec = now.tv_sec + timeout_ms / 1000 + nsec / 1000000000L;
    ts.tv_nsec = nsec % 1000000000L;
    while (r->count == 0) {
      if (pthread_cond_timedwait(&r->cv, &r->mu, &ts) != 0) break;
    }
  }
  if (r->count == 0) {
    pthread_mutex_unlock(&r->mu);
    return -1;
  }
  int slot = r->tail;
  *n = r->counts[slot];
  memcpy(ranges, r->ranges + (size_t)slot * r->max_beams, *n * sizeof(float));
  memcpy(pose, r->poses + (size_t)slot * 3, 3 * sizeof(float));
  *stamp = r->stamps[slot];
  r->tail = (r->tail + 1) % r->capacity;
  r->count--;
  pthread_mutex_unlock(&r->mu);
  return 0;
}

int ring_size(void* h) {
  auto* r = (Ring*)h;
  pthread_mutex_lock(&r->mu);
  int c = r->count;
  pthread_mutex_unlock(&r->mu);
  return c;
}

int ring_dropped(void* h) {
  auto* r = (Ring*)h;
  pthread_mutex_lock(&r->mu);
  int c = r->dropped;
  pthread_mutex_unlock(&r->mu);
  return c;
}

// ---------------------------------------------------------------------------
// TCP scan-frame transport (the tcp_slam wire protocol role:
// length-prefixed frames, scans upstream / pose updates downstream,
// serverSocket.cpp:43-116)
// ---------------------------------------------------------------------------

static const uint32_t SCAN_MAGIC = 0x4C534654;  // "LSFT"
static const uint32_t POSE_MAGIC = 0x4C535055;  // "LSPU"

static int write_all(int fd, const void* buf, size_t n) {
  const char* p = (const char*)buf;
  while (n > 0) {
    ssize_t w = write(fd, p, n);
    if (w <= 0) return -1;
    p += w;
    n -= w;
  }
  return 0;
}

static int read_all(int fd, void* buf, size_t n) {
  char* p = (char*)buf;
  while (n > 0) {
    ssize_t r = read(fd, p, n);
    if (r <= 0) return -1;
    p += r;
    n -= r;
  }
  return 0;
}

int tcp_serve(int port) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons((uint16_t)port);
  if (bind(fd, (sockaddr*)&addr, sizeof(addr)) < 0 || listen(fd, 4) < 0) {
    close(fd);
    return -1;
  }
  return fd;
}

int tcp_accept(int listen_fd, int timeout_ms) {
  if (timeout_ms > 0) {
    fd_set rfds;
    FD_ZERO(&rfds);
    FD_SET(listen_fd, &rfds);
    timeval tv{timeout_ms / 1000, (timeout_ms % 1000) * 1000};
    if (select(listen_fd + 1, &rfds, nullptr, nullptr, &tv) <= 0) return -1;
  }
  int fd = accept(listen_fd, nullptr, nullptr);
  if (fd >= 0) {
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  }
  return fd;
}

int tcp_connect(const char* host, int port) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1 ||
      connect(fd, (sockaddr*)&addr, sizeof(addr)) < 0) {
    close(fd);
    return -1;
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return fd;
}

void tcp_close(int fd) { close(fd); }

// Frame: magic u32 | payload_len u32 | payload
// Scan payload: stamp f64 | pose f32[3] | cov f32[6] | n u32 | ranges f32[n]
int send_scan_frame(int fd, const float* ranges, int n, const float* pose,
                    const float* cov6, double stamp) {
  uint32_t payload = 8 + 12 + 24 + 4 + 4 * (uint32_t)n;
  std::vector<char> buf(8 + payload);
  char* p = buf.data();
  uint32_t magic = htonl(SCAN_MAGIC), plen = htonl(payload);
  memcpy(p, &magic, 4); p += 4;
  memcpy(p, &plen, 4); p += 4;
  memcpy(p, &stamp, 8); p += 8;
  memcpy(p, pose, 12); p += 12;
  memcpy(p, cov6, 24); p += 24;
  uint32_t nn = htonl((uint32_t)n);
  memcpy(p, &nn, 4); p += 4;
  memcpy(p, ranges, 4 * (size_t)n);
  return write_all(fd, buf.data(), buf.size());
}

int recv_scan_frame(int fd, float* ranges, int max_n, int* n, float* pose,
                    float* cov6, double* stamp) {
  uint32_t hdr[2];
  if (read_all(fd, hdr, 8) < 0) return -1;
  if (ntohl(hdr[0]) != SCAN_MAGIC) return -2;
  uint32_t payload = ntohl(hdr[1]);
  std::vector<char> buf(payload);
  if (read_all(fd, buf.data(), payload) < 0) return -1;
  char* p = buf.data();
  memcpy(stamp, p, 8); p += 8;
  memcpy(pose, p, 12); p += 12;
  memcpy(cov6, p, 24); p += 24;
  uint32_t nn;
  memcpy(&nn, p, 4); p += 4;
  nn = ntohl(nn);
  if ((int)nn > max_n) return -3;
  memcpy(ranges, p, 4 * (size_t)nn);
  *n = (int)nn;
  return 0;
}

// Pose payload: id s32 | pose f32[3] | cov f32[6]
int send_pose_update(int fd, int id, const float* pose, const float* cov6) {
  uint32_t payload = 4 + 12 + 24;
  char buf[8 + 4 + 12 + 24];
  char* p = buf;
  uint32_t magic = htonl(POSE_MAGIC), plen = htonl(payload);
  memcpy(p, &magic, 4); p += 4;
  memcpy(p, &plen, 4); p += 4;
  int32_t nid = (int32_t)htonl((uint32_t)id);
  memcpy(p, &nid, 4); p += 4;
  memcpy(p, pose, 12); p += 12;
  memcpy(p, cov6, 24);
  return write_all(fd, buf, sizeof(buf));
}

int recv_pose_update(int fd, int* id, float* pose, float* cov6) {
  uint32_t hdr[2];
  if (read_all(fd, hdr, 8) < 0) return -1;
  if (ntohl(hdr[0]) != POSE_MAGIC) return -2;
  uint32_t payload = ntohl(hdr[1]);
  if (payload != 40) return -2;
  char buf[40];
  if (read_all(fd, buf, 40) < 0) return -1;
  uint32_t nid;
  memcpy(&nid, buf, 4);
  *id = (int)ntohl(nid);
  memcpy(pose, buf + 4, 12);
  memcpy(cov6, buf + 16, 24);
  return 0;
}

// Peek next frame type: 1 = scan, 2 = pose, -1 = error.
int recv_frame_type(int fd) {
  uint32_t magic;
  if (read_all(fd, &magic, 4) < 0) return -1;
  magic = ntohl(magic);
  // Push back is not possible on a raw fd; instead the caller uses
  // typed receive variants below which take the already-read magic.
  if (magic == SCAN_MAGIC) return 1;
  if (magic == POSE_MAGIC) return 2;
  return -1;
}

// Body receivers for use after recv_frame_type.
int recv_scan_body(int fd, float* ranges, int max_n, int* n, float* pose,
                   float* cov6, double* stamp) {
  uint32_t plen;
  if (read_all(fd, &plen, 4) < 0) return -1;
  uint32_t payload = ntohl(plen);
  std::vector<char> buf(payload);
  if (read_all(fd, buf.data(), payload) < 0) return -1;
  char* p = buf.data();
  memcpy(stamp, p, 8); p += 8;
  memcpy(pose, p, 12); p += 12;
  memcpy(cov6, p, 24); p += 24;
  uint32_t nn;
  memcpy(&nn, p, 4); p += 4;
  nn = ntohl(nn);
  if ((int)nn > max_n) return -3;
  memcpy(ranges, p, 4 * (size_t)nn);
  *n = (int)nn;
  return 0;
}

int recv_pose_body(int fd, int* id, float* pose, float* cov6) {
  uint32_t plen;
  if (read_all(fd, &plen, 4) < 0) return -1;
  if (ntohl(plen) != 40) return -2;
  char buf[40];
  if (read_all(fd, buf, 40) < 0) return -1;
  uint32_t nid;
  memcpy(&nid, buf, 4);
  *id = (int)ntohl(nid);
  memcpy(pose, buf + 4, 12);
  memcpy(cov6, buf + 16, 24);
  return 0;
}

// ---------------------------------------------------------------------------
// SICK CoLa-A telegram codec (protocol layer of the reference's live
// driver, CSICK.cpp:101-160; telegrams are <STX>sXX name args<ETX>)
// ---------------------------------------------------------------------------

int cola_build(const char* cmd, char* out, int max) {
  int n = (int)strlen(cmd);
  if (n + 2 > max) return -1;
  out[0] = 0x02;
  memcpy(out + 1, cmd, n);
  out[n + 1] = 0x03;
  return n + 2;
}

// Extract the payload between STX/ETX; returns length or -1.
int cola_unwrap(const char* telegram, int len, char* out, int max) {
  int s = -1, e = -1;
  for (int i = 0; i < len; i++) {
    if (telegram[i] == 0x02) s = i + 1;
    else if (telegram[i] == 0x03) { e = i; break; }
  }
  if (s < 0 || e < 0 || e <= s || e - s > max) return -1;
  memcpy(out, telegram + s, e - s);
  return e - s;
}

// Parse LMDscandata DIST1 block: "... DIST1 <scale hexfloat> <offset>
// <startangle> <step> <count> <v0> <v1> ..." — values are hex mm.
// Returns beam count, ranges in meters; -1 if no DIST1 section.
int cola_parse_scandata(const char* payload, int len, float* ranges,
                        int max_n) {
  std::string s(payload, len);
  size_t pos = s.find("DIST1");
  if (pos == std::string::npos) return -1;
  std::vector<std::string> tok;
  {
    size_t i = pos;
    while (i < s.size() && (int)tok.size() < 7 + max_n) {
      while (i < s.size() && s[i] == ' ') i++;
      size_t j = i;
      while (j < s.size() && s[j] != ' ') j++;
      if (j > i) tok.push_back(s.substr(i, j - i));
      i = j;
    }
  }
  if (tok.size() < 6) return -1;
  // tok[0]=DIST1, [1]=scale (hex IEEE754), [2]=offset, [3]=start, [4]=step,
  // [5]=count, then values
  uint32_t scale_bits = (uint32_t)strtoul(tok[1].c_str(), nullptr, 16);
  float scale;
  memcpy(&scale, &scale_bits, 4);
  if (!(scale > 0.0f && scale < 100.0f)) scale = 1.0f;
  int count = (int)strtol(tok[5].c_str(), nullptr, 16);
  if (count <= 0 || count > max_n || (int)tok.size() < 6 + count) return -1;
  for (int i = 0; i < count; i++) {
    long mm = strtol(tok[6 + i].c_str(), nullptr, 16);
    ranges[i] = (float)mm * scale / 1000.0f;
  }
  return count;
}

}  // extern "C"
