// Native I420 -> RGB converter (BT.601 video range).
//
// The port's copy of gsvc_tpu/native/yuv.cpp: the reference's
// cv2.COLOR_YUV2RGB_I420 decode in process_yuv_video (utils.py:134-156),
// with the ITU-R BT.601 fixed-point coefficients and rounding OpenCV uses,
// so its output is bit-identical to cv2's and to the int32 numpy plain
// version in gsvc_tpu_torch/io/yuv.py. Loaded via ctypes by
// gsvc_tpu_torch/native/__init__.py; gsvc_tpu_torch/_build.py compiles it
// with g++ at first use.

#include <algorithm>
#include <cstdint>
#include <cstddef>

namespace {

constexpr int kShift = 20;
constexpr int kCY = 1220542;   // 1.164 * 2^20
constexpr int kCUB = 2116026;  // 2.018 * 2^20
constexpr int kCUG = -409993;  // -0.391 * 2^20
constexpr int kCVG = -852492;  // -0.813 * 2^20
constexpr int kCVR = 1673527;  // 1.596 * 2^20
constexpr int kRound = 1 << (kShift - 1);

inline uint8_t clamp8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

}  // namespace

extern "C" {

// yuv: I420 planar frame, (h*3/2) x w bytes. rgb out: h x w x 3.
void yuv420_to_rgb(const uint8_t* yuv, int width, int height, uint8_t* rgb) {
  const uint8_t* yp = yuv;
  const uint8_t* up = yuv + static_cast<size_t>(width) * height;
  const uint8_t* vp = up + static_cast<size_t>(width / 2) * (height / 2);
  for (int row = 0; row < height; ++row) {
    const uint8_t* yrow = yp + static_cast<size_t>(row) * width;
    const uint8_t* urow = up + static_cast<size_t>(row / 2) * (width / 2);
    const uint8_t* vrow = vp + static_cast<size_t>(row / 2) * (width / 2);
    uint8_t* out = rgb + static_cast<size_t>(row) * width * 3;
    for (int col = 0; col < width; ++col) {
      const int y = std::max(0, static_cast<int>(yrow[col]) - 16) * kCY;
      const int u = static_cast<int>(urow[col / 2]) - 128;
      const int v = static_cast<int>(vrow[col / 2]) - 128;
      out[3 * col + 0] = clamp8((y + kCVR * v + kRound) >> kShift);
      out[3 * col + 1] = clamp8((y + kCVG * v + kCUG * u + kRound) >> kShift);
      out[3 * col + 2] = clamp8((y + kCUB * u + kRound) >> kShift);
    }
  }
}

}  // extern "C"
