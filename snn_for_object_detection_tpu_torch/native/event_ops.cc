// Fused event decode + rasterize kernels for the host data path (the
// port's copy of snn_for_object_detection_tpu/native/event_ops.cc).
//
// The reference rasterizes via numpy fancy-indexing over decoded column
// arrays (its utils/datasets.py:331-336,428-433), which
// materializes four intermediate arrays per window and walks memory
// five times. At 1Mpx resolution (1280x720, SURVEY.md §7.3 "host-side
// input throughput") that starves the device. This kernel does one pass
// over the raw .dat records: unpack word -> scatter into the frame
// tensor, no intermediates.
//
// Record format (SURVEY.md §2.6): two little-endian uint32 words per
// event; word0 = timestamp µs, word1 = x:14 | y:14 | p:4.
//
// Build (bindings.py, at first use, into build/native/):
// g++ -O3 -shared -fPIC -std=c++17 event_ops.cc -o libevent_ops.so

#include <cstdint>
#include <cstring>

extern "C" {

// Decode raw records into column arrays (the EventReader fast path).
void decode_events(const uint32_t* records, int64_t n,
                   uint32_t* t, uint16_t* x, uint16_t* y, uint8_t* p) {
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t ts = records[2 * i];
    const uint32_t w = records[2 * i + 1];
    t[i] = ts;
    x[i] = static_cast<uint16_t>(w & 0x3FFF);
    y[i] = static_cast<uint16_t>((w >> 14) & 0x3FFF);
    // CD polarity is one bit; mask like rasterize_records so both
    // decode paths agree even on records with spare bits set
    p[i] = static_cast<uint8_t>((w >> 28) & 0x1);
  }
}

// Fused decode + scatter into [num_steps, H, W, 2] float32 frames.
//
// Events with timestamp < t_min_us are skipped (the ST sampler's
// leading-window filter, datasets.py:416); frame index =
// (t - t_min_us) / step_us; x is clipped into [0, W) when clip_x != 0
// (1Mpx quirk, datasets.py:425-426). Returns the number of in-window
// events — counted BEFORE the spatial bounds check, matching the
// reference's events-per-frame threshold (datasets.py:417), which
// counts time-filtered events regardless of coordinates.
int64_t rasterize_records(const uint32_t* records, int64_t n,
                          int64_t t_min_us, int64_t step_us,
                          int32_t num_steps, int32_t height, int32_t width,
                          int32_t clip_x, float* frames) {
  const int64_t frame_stride = static_cast<int64_t>(height) * width * 2;
  const int64_t row_stride = static_cast<int64_t>(width) * 2;
  int64_t count = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t ts = static_cast<int64_t>(records[2 * i]);
    if (ts < t_min_us) continue;
    const int64_t f = (ts - t_min_us) / step_us;
    if (f < 0 || f >= num_steps) continue;
    ++count;
    const uint32_t w = records[2 * i + 1];
    int32_t ex = static_cast<int32_t>(w & 0x3FFF);
    const int32_t ey = static_cast<int32_t>((w >> 14) & 0x3FFF);
    const int32_t ep = static_cast<int32_t>((w >> 28) & 0x1);
    if (clip_x) ex = ex < 0 ? 0 : (ex >= width ? width - 1 : ex);
    if (ex >= width || ey >= height) continue;
    frames[f * frame_stride + ey * row_stride + ex * 2 + ep] = 1.0f;
  }
  return count;
}

// uint8 variant: the frame tensor is 4x smaller than float32, which
// matters twice — the memset of the [T, H, W, 2] buffer dominates the
// 1Mpx rasterization cost, and the host->device transfer shrinks 4x.
// The model casts to its compute dtype on the device.
int64_t rasterize_records_u8(const uint32_t* records, int64_t n,
                             int64_t t_min_us, int64_t step_us,
                             int32_t num_steps, int32_t height,
                             int32_t width, int32_t clip_x,
                             uint8_t* frames) {
  const int64_t frame_stride = static_cast<int64_t>(height) * width * 2;
  const int64_t row_stride = static_cast<int64_t>(width) * 2;
  int64_t count = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t ts = static_cast<int64_t>(records[2 * i]);
    if (ts < t_min_us) continue;
    const int64_t f = (ts - t_min_us) / step_us;
    if (f < 0 || f >= num_steps) continue;
    ++count;
    const uint32_t w = records[2 * i + 1];
    int32_t ex = static_cast<int32_t>(w & 0x3FFF);
    const int32_t ey = static_cast<int32_t>((w >> 14) & 0x3FFF);
    const int32_t ep = static_cast<int32_t>((w >> 28) & 0x1);
    if (clip_x) ex = ex < 0 ? 0 : (ex >= width ? width - 1 : ex);
    if (ex >= width || ey >= height) continue;
    frames[f * frame_stride + ey * row_stride + ex * 2 + ep] = 1;
  }
  return count;
}

}  // extern "C"
