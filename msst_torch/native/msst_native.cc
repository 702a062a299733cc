// Native host runtime for msst_torch (the port's own copy of msst_tpu's
// msst_native.cc).
//
// C++ equivalents of the reference's C++ driver internals, exposed through a
// plain C ABI for ctypes:
//   * decode_packets   — batch Velodyne-style 1206-byte packet decode
//                        (the timoo_pointcloud RawData::unpack role,
//                        timoo/src/timoo_pointcloud/src/lib/rawdata.cc:306-519)
//                        with a precomputed sin/cos LUT over 36000 azimuth
//                        steps like the reference (:263-267);
//   * pcap_read_packets — offline pcap replay source (the InputPCAP role,
//                        timoo/src/timoo_driver/src/lib/input.cc:264-380);
//   * udp_open/udp_recv_batch — live UDP capture with poll() timeout
//                        (InputSocket::getPacket, input.cc:131-190);
//   * ring buffer      — lock-free SPSC packet queue for the capture thread
//                        (replaces the ROS-queue decoupling);
//   * pack_scan_q16    — one-pass int16 quantization of a scan's points into
//                        a window upload row (LioSam's q16 layout,
//                        mapping.odometry_window_flat_q16).
//
// Built at its first use by msst_torch/utils/native.py (g++ -O3 -fPIC
// -std=c++17 -shared) into msst_torch/build/libmsst_native-<hash>.so.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

namespace {

constexpr int kPacketSize = 1206;
constexpr int kBlocks = 12;
constexpr int kChannels = 32;
constexpr int kMaxLasers = 64;
constexpr uint16_t kUpperBank = 0xEEFF;
constexpr uint16_t kLowerBank = 0xDDFF;
// two-point distance-interpolation anchors (rawdata.cc:409-419)
constexpr float kTwoPtFar = 25.04f;
constexpr float kTwoPtNearX = 2.4f;
constexpr float kTwoPtNearY = 1.93f;

// Full decoder configuration — mirrors packets._native_cfg_struct
// (msst_torch/utils/packets.py, kept in lockstep) and the reference's
// Calibration + Config pair
// (timoo_pointcloud/include/timoo_pointcloud/calibration.h:51-73,
// rawdata.cc setup() :202-269).
struct DecCfg {
  int num_lasers;
  float distance_resolution;
  float min_range, max_range;
  float firing_cycle_us, single_firing_us;
  int n_windows;
  int win_lo[4], win_hi[4];  // kept azimuth sectors, centidegrees
  uint64_t hide_mask;        // rings restricted to the windows (hide_line)
  int filter_enabled;
  float filter_threshold[4];
  float vert_rad[kMaxLasers], rot_rad[kMaxLasers], dist_corr[kMaxLasers];
  float two_pt[kMaxLasers], dist_x[kMaxLasers], dist_y[kMaxLasers];
  float vert_off[kMaxLasers], horiz_off[kMaxLasers];
  float focal_dist[kMaxLasers], focal_slope[kMaxLasers];
  float min_int[kMaxLasers], max_int[kMaxLasers];
  int32_t ring[kMaxLasers];
};

inline bool in_windows(const DecCfg& c, int az_cd) {
  // azimuth-window test with wraparound (rawdata.cc:351-364)
  for (int w = 0; w < c.n_windows; ++w) {
    if (c.win_lo[w] < c.win_hi[w]) {
      if (az_cd >= c.win_lo[w] && az_cd <= c.win_hi[w]) return true;
    } else {
      if (az_cd <= c.win_hi[w] || az_cd >= c.win_lo[w]) return true;
    }
  }
  return false;
}

// The shared per-point correction pipeline (rawdata.cc:334-460): rot
// correction, two-point distance interpolation, horiz/vert offsets,
// focal-curve intensity, ROS frame swap.
inline void correct_point(const DecCfg& c, int laser, uint16_t raw, int az_cd,
                          uint8_t inten_raw, bool tm16_quirk, float* out_x,
                          float* out_y, float* out_z, float* out_i,
                          float* out_d) {
  float dist = raw * c.distance_resolution + c.dist_corr[laser];
  float ang = az_cd * static_cast<float>(M_PI / 18000.0) - c.rot_rad[laser];
  float cos_rot = std::cos(ang), sin_rot = std::sin(ang);
  float cos_v = std::cos(c.vert_rad[laser]), sin_v = std::sin(c.vert_rad[laser]);
  float v_off = c.vert_off[laser], h_off = c.horiz_off[laser];

  float xy = dist * cos_v - v_off * sin_v;
  float xx = std::fabs(xy * sin_rot - h_off * cos_rot);
  float yy = std::fabs(xy * cos_rot + h_off * sin_rot);

  float corr_x = 0.f, corr_y = 0.f;
  if (c.two_pt[laser] > 0.5f) {
    float dc = c.dist_corr[laser];
    corr_x = (dc - c.dist_x[laser]) * (xx - kTwoPtNearX) /
                 (kTwoPtFar - kTwoPtNearX) +
             c.dist_x[laser] - dc;
    corr_y = (dc - c.dist_y[laser]) * (yy - kTwoPtNearY) /
                 (kTwoPtFar - kTwoPtNearY) +
             c.dist_y[laser] - dc;
  }
  float dx = dist + corr_x, dy = dist + corr_y;
  float px = (dx * cos_v - v_off * sin_v) * sin_rot - h_off * cos_rot;
  float py = (dy * cos_v - v_off * sin_v) * cos_rot + h_off * sin_rot;
  float pz = dy * sin_v + v_off * cos_v;
  // ROS right-hand frame (:454-456)
  *out_x = py;
  *out_y = -px;
  *out_z = pz;

  float fd = c.focal_dist[laser];
  float fo = 256.0f * (1.0f - fd / 13100.0f) * (1.0f - fd / 13100.0f);
  float term;
  if (tm16_quirk) {
    // TM16 path divides the raw uint in INTEGER math (rawdata.cc:718)
    int q = 1 - raw / 65535;
    term = 256.0f * q * q;
  } else {
    float r = 1.0f - static_cast<float>(raw) / 65535.0f;
    term = 256.0f * r * r;
  }
  float inten = inten_raw + c.focal_slope[laser] * std::fabs(fo - term);
  inten = std::max(c.min_int[laser], std::min(c.max_int[laser], inten));
  *out_i = inten;
  *out_d = dist;
}

}  // namespace

extern "C" {

// packets: n * 1206 uint8. Outputs are n*12*32 flat arrays aligned to
// (packet, block, channel) slots with a validity mask (invalid slots keep
// whatever geometry was computed but valid=0). Behavior matches
// packets.decode_packets_numpy exactly (tested).
int decode_packets(const uint8_t* packets, int n, const DecCfg* cfg, float* x,
                   float* y, float* z, float* intensity, int32_t* ring,
                   float* time_us, float* azimuth_deg, uint8_t* valid) {
  const DecCfg& c = *cfg;
  const bool tm16 = c.num_lasers == 16;
  // TM16 denoiser state: 3-deep per-ring sliding window over the firing
  // stream (filter_tm16 :748-796); emits slot of window middle when deltas
  // pass the band threshold of the incoming point's distance
  float win_d[16][3];
  size_t win_slot[16][3];
  uint8_t win_ok[16][3];
  int win_n[16] = {0};

  for (int p = 0; p < n; ++p) {
    const uint8_t* pkt = packets + static_cast<size_t>(p) * kPacketSize;
    uint16_t flags[kBlocks];
    int rot[kBlocks];
    for (int b = 0; b < kBlocks; ++b) {
      const uint8_t* blk = pkt + b * 100;
      flags[b] = static_cast<uint16_t>(blk[0] | (blk[1] << 8));
      rot[b] = blk[2] | (blk[3] << 8);
    }

    if (tm16) {
      // a non-upper-bank header aborts the rest of the packet (:540-549)
      int n_ok = kBlocks;
      for (int b = 0; b < kBlocks; ++b)
        if (flags[b] != kUpperBank) {
          n_ok = b;
          break;
        }
      float last = 0.f;
      for (int b = 0; b < kBlocks; ++b) {
        const uint8_t* data = pkt + b * 100 + 4;
        bool blk_ok = b < n_ok;
        float az_diff;
        if (b < kBlocks - 1) {
          int rd = rot[b + 1] - rot[b];
          float d = static_cast<float>((36000 + rd) % 36000);
          if (rd < 0) {
            if (last > 0.f)
              d = last;
            else
              blk_ok = false;  // skip block (:573-578)
          }
          if (!(rd < 0 && !(last > 0.f))) last = d;
          az_diff = d;
        } else {
          az_diff = last;
        }
        for (int firing = 0; firing < 2; ++firing) {
          for (int dsr = 0; dsr < 16; ++dsr) {
            int k = (firing * 16 + dsr) * 3;
            uint16_t raw =
                static_cast<uint16_t>(data[k] | (data[k + 1] << 8));
            // per-point interpolated azimuth (:585-591)
            float frac = (dsr * c.single_firing_us +
                          firing * c.firing_cycle_us) /
                         (2.0f * c.firing_cycle_us);
            int az_cd = static_cast<int>(
                std::floor(rot[b] + az_diff * frac + 0.5f));
            az_cd %= 36000;

            size_t o = ((static_cast<size_t>(p) * kBlocks + b) * 2 + firing) *
                           16 +
                       dsr;
            float d_corr;
            correct_point(c, dsr, raw, az_cd, data[k + 2], true, &x[o], &y[o],
                          &z[o], &intensity[o], &d_corr);
            int rg = c.ring[dsr];
            ring[o] = rg;
            azimuth_deg[o] = az_cd / 100.0f;
            // timing offsets rebased to packet end (buildTimings :160-176)
            time_us[o] = c.firing_cycle_us * (2 * b + firing) +
                         c.single_firing_us * (dsr + 1) -
                         2 * kBlocks * c.firing_cycle_us;
            bool ok = blk_ok && d_corr >= c.min_range && d_corr <= c.max_range;
            // hide_line: listed rings keep only window points (:601-618)
            if (c.hide_mask >> rg & 1) ok = ok && in_windows(c, az_cd);

            if (c.filter_enabled) {
              // a point is only emitted once it becomes the middle of a
              // full window and the deltas pass; until then it is invalid
              valid[o] = 0;
              if (win_n[dsr] == 3) {
                float delta1 = std::fabs(win_d[dsr][0] - win_d[dsr][1]) * 200.f;
                float delta2 = std::fabs(win_d[dsr][2] - win_d[dsr][1]) * 200.f;
                float band;
                if (d_corr < 2.56f)
                  band = 8 * 0.1f * c.filter_threshold[0];
                else if (d_corr < 5.12f)
                  band = 26 * 0.1f * c.filter_threshold[1];
                else if (d_corr < 10.24f)
                  band = 48 * 0.1f * c.filter_threshold[2];
                else
                  band = 1024 * 0.1f * c.filter_threshold[3];
                if (delta1 < band && delta2 < band)
                  valid[win_slot[dsr][1]] = win_ok[dsr][1];
                win_d[dsr][0] = win_d[dsr][1];
                win_d[dsr][1] = win_d[dsr][2];
                win_slot[dsr][0] = win_slot[dsr][1];
                win_slot[dsr][1] = win_slot[dsr][2];
                win_ok[dsr][0] = win_ok[dsr][1];
                win_ok[dsr][1] = win_ok[dsr][2];
                win_n[dsr] = 2;
              }
              win_d[dsr][win_n[dsr]] = d_corr;
              win_slot[dsr][win_n[dsr]] = o;
              win_ok[dsr][win_n[dsr]] = ok ? 1 : 0;
              win_n[dsr] += 1;
            } else {
              valid[o] = ok ? 1 : 0;
            }
          }
        }
      }
    } else {
      // generic banked path (unpack :306-519)
      for (int b = 0; b < kBlocks; ++b) {
        const uint8_t* data = pkt + b * 100 + 4;
        int bank = 0;
        bool known = true;
        if (flags[b] == kLowerBank)
          bank = 32;
        else if (flags[b] != kUpperBank)
          known = false;
        int az_cd = rot[b] % 36000;
        for (int j = 0; j < kChannels; ++j) {
          int laser_n = bank + j;
          int laser = laser_n < c.num_lasers ? laser_n : c.num_lasers - 1;
          uint16_t raw = static_cast<uint16_t>(data[j * 3] |
                                               (data[j * 3 + 1] << 8));
          size_t o = (static_cast<size_t>(p) * kBlocks + b) * kChannels + j;
          float d_corr;
          correct_point(c, laser, raw, az_cd, data[j * 3 + 2], false, &x[o],
                        &y[o], &z[o], &intensity[o], &d_corr);
          int rg = c.ring[laser];
          ring[o] = rg;
          azimuth_deg[o] = az_cd / 100.0f;
          time_us[o] = 0.f;  // timings only built for TM16 (:178-181)
          bool ok = known && laser_n < c.num_lasers && raw > 0 &&
                    in_windows(c, az_cd) && d_corr >= c.min_range &&
                    d_corr <= c.max_range;
          if (c.hide_mask >> rg & 1) ok = false;
          valid[o] = ok ? 1 : 0;
        }
      }
    }
  }
  return n * kBlocks * kChannels;
}

// ---------------------------------------------------------------------------
// pcap replay (InputPCAP role). Parses classic pcap files without libpcap:
// 24-byte global header, then per-record [ts_sec, ts_usec, incl_len,
// orig_len] + data; the UDP payload of a 1248-byte Ethernet frame starts at
// offset 42. Returns number of packets extracted (up to max_packets).
int pcap_read_packets(const char* path, uint8_t* out, double* stamps,
                      int max_packets) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  uint8_t ghdr[24];
  if (std::fread(ghdr, 1, 24, f) != 24) {
    std::fclose(f);
    return -1;
  }
  uint32_t magic;
  std::memcpy(&magic, ghdr, 4);
  bool swapped;
  if (magic == 0xa1b2c3d4)
    swapped = false;
  else if (magic == 0xd4c3b2a1)
    swapped = true;
  else {
    std::fclose(f);
    return -2;  // not a classic pcap
  }
  auto rd32 = [&](const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return swapped ? __builtin_bswap32(v) : v;
  };

  int count = 0;
  std::vector<uint8_t> buf(65536);
  while (count < max_packets) {
    uint8_t rhdr[16];
    if (std::fread(rhdr, 1, 16, f) != 16) break;
    uint32_t ts_sec = rd32(rhdr);
    uint32_t ts_usec = rd32(rhdr + 4);
    uint32_t incl = rd32(rhdr + 8);
    if (incl > buf.size()) {
      std::fclose(f);
      return -3;
    }
    if (std::fread(buf.data(), 1, incl, f) != incl) break;
    if (incl >= 42 + kPacketSize) {
      std::memcpy(out + static_cast<size_t>(count) * kPacketSize,
                  buf.data() + 42, kPacketSize);
      stamps[count] = ts_sec + ts_usec * 1e-6;
      ++count;
    }
  }
  std::fclose(f);
  return count;
}

// ---------------------------------------------------------------------------
// live UDP capture (InputSocket role)
int udp_open(int port, int rcvbuf_bytes) {
  int fd = ::socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  if (rcvbuf_bytes > 0)
    ::setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &rcvbuf_bytes, sizeof(rcvbuf_bytes));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = INADDR_ANY;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    ::close(fd);
    return -2;
  }
  int flags = ::fcntl(fd, F_GETFL, 0);
  ::fcntl(fd, F_SETFL, flags | O_NONBLOCK);
  return fd;
}

// poll()-guarded batch receive (input.cc:131-190); returns packets received.
int udp_recv_batch(int fd, uint8_t* out, int max_packets, int timeout_ms) {
  int count = 0;
  while (count < max_packets) {
    pollfd pfd{fd, POLLIN, 0};
    int pr = ::poll(&pfd, 1, timeout_ms);
    if (pr <= 0) break;
    ssize_t n = ::recv(fd, out + static_cast<size_t>(count) * kPacketSize,
                       kPacketSize, 0);
    if (n == kPacketSize) ++count;
    // short/oversize datagrams are dropped, like the reference's size check
  }
  return count;
}

void udp_close(int fd) { ::close(fd); }

// ---------------------------------------------------------------------------
// lock-free SPSC ring buffer of packets (driver thread -> consumer)
struct PacketRing {
  std::vector<uint8_t> data;
  std::vector<double> stamps;
  size_t capacity;
  std::atomic<size_t> head{0}, tail{0};
};

void* ring_create(int capacity) {
  auto* r = new PacketRing();
  r->capacity = static_cast<size_t>(capacity);
  r->data.resize(r->capacity * kPacketSize);
  r->stamps.resize(r->capacity);
  return r;
}

int ring_push(void* ring, const uint8_t* pkt, double stamp) {
  auto* r = static_cast<PacketRing*>(ring);
  size_t h = r->head.load(std::memory_order_relaxed);
  size_t t = r->tail.load(std::memory_order_acquire);
  if (h - t >= r->capacity) return 0;  // full -> drop (bounded queue)
  std::memcpy(&r->data[(h % r->capacity) * kPacketSize], pkt, kPacketSize);
  r->stamps[h % r->capacity] = stamp;
  r->head.store(h + 1, std::memory_order_release);
  return 1;
}

int ring_pop_batch(void* ring, uint8_t* out, double* stamps, int max_packets) {
  auto* r = static_cast<PacketRing*>(ring);
  size_t t = r->tail.load(std::memory_order_relaxed);
  size_t h = r->head.load(std::memory_order_acquire);
  int count = 0;
  while (t < h && count < max_packets) {
    std::memcpy(out + static_cast<size_t>(count) * kPacketSize,
                &r->data[(t % r->capacity) * kPacketSize], kPacketSize);
    stamps[count] = r->stamps[t % r->capacity];
    ++t;
    ++count;
  }
  r->tail.store(t, std::memory_order_release);
  return count;
}

int ring_size(void* ring) {
  auto* r = static_cast<PacketRing*>(ring);
  return static_cast<int>(r->head.load() - r->tail.load());
}

void ring_destroy(void* ring) { delete static_cast<PacketRing*>(ring); }

// Quantize n points (xyz, per-point time, ring) into max_points rows of 5
// int16: clip(rint(v * scale), +-32767) per column, rows past n zeroed.
void pack_scan_q16(const float* xyz, const float* time_rel,
                   const int32_t* ring, int n, int max_points,
                   const float* scales /* 5 */, int16_t* out) {
  if (n > max_points) n = max_points;
  const float sx = scales[0], sy = scales[1], sz = scales[2],
              st = scales[3], sr = scales[4];
  auto q = [](float v) -> int16_t {
    v = v < -32767.f ? -32767.f : (v > 32767.f ? 32767.f : v);
    return static_cast<int16_t>(lrintf(v));
  };
  for (int i = 0; i < n; ++i) {
    int16_t* row = out + 5 * i;
    row[0] = q(xyz[3 * i + 0] * sx);
    row[1] = q(xyz[3 * i + 1] * sy);
    row[2] = q(xyz[3 * i + 2] * sz);
    row[3] = q(time_rel[i] * st);
    row[4] = q(static_cast<float>(ring[i]) * sr);
  }
  if (n < max_points)
    memset(out + 5 * n, 0, sizeof(int16_t) * 5 * (max_points - n));
}

}  // extern "C"
