// Artifact writer: a native worker pool that colormaps float attention maps
// and encodes them, and RGB images, to PNG off the Python thread.
//
// C interface for ctypes:
//   aw_create(n_threads) -> handle
//   aw_submit_gray(handle, data_f32, h, w, path, apply_viridis, level)
//   aw_submit_rgb8(handle, data_u8, h, w, path, level)
//   aw_write_rgb8(data_u8, h, w, path, level) -> 1 on success (synchronous)
//   aw_encode_rgb8(data_u8, h, w, level, &out, &len) -> 1 on success: the
//                      PNG bytes write_rgb8 would write, in a buffer that
//                      aw_free releases (synchronous)
//   aw_free(buffer)
//   aw_pending(handle) -> queued + running jobs
//   aw_flush(handle)   -> block until none is left; returns the number of
//                         jobs that failed to write since the last flush
//   aw_destroy(handle)
//
// PNG: 8-bit RGB, filter type 0, one IDAT chunk compressed by zlib's
// compress2 at the given level.

#include <zlib.h>

#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

bool zlib_stream(const std::vector<uint8_t>& raw, int level, std::vector<uint8_t>& out) {
  uLongf bound = compressBound(static_cast<uLong>(raw.size()));
  out.resize(bound);
  if (compress2(out.data(), &bound, raw.data(), static_cast<uLong>(raw.size()), level) != Z_OK) return false;
  out.resize(bound);
  return true;
}

// ---------------------------------------------------------------------------
// PNG encoding
// ---------------------------------------------------------------------------

void put_u32(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back((v >> 24) & 0xff);
  out.push_back((v >> 16) & 0xff);
  out.push_back((v >> 8) & 0xff);
  out.push_back(v & 0xff);
}

void put_chunk(std::vector<uint8_t>& out, const char type[4], const uint8_t* data, size_t len) {
  put_u32(out, static_cast<uint32_t>(len));
  size_t start = out.size();
  out.insert(out.end(), type, type + 4);
  if (len) out.insert(out.end(), data, data + len);
  put_u32(out, static_cast<uint32_t>(crc32(0, out.data() + start, static_cast<uInt>(4 + len))));
}

bool encode_png_rgb8(const uint8_t* rgb, int h, int w, int level, std::vector<uint8_t>& png) {
  std::vector<uint8_t> raw;
  raw.reserve(static_cast<size_t>(h) * (static_cast<size_t>(w) * 3 + 1));
  for (int y = 0; y < h; ++y) {
    raw.push_back(0);  // filter type: none
    raw.insert(raw.end(), rgb + static_cast<size_t>(y) * w * 3, rgb + static_cast<size_t>(y + 1) * w * 3);
  }
  std::vector<uint8_t> idat;
  if (!zlib_stream(raw, level, idat)) return false;

  png.clear();
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  png.insert(png.end(), sig, sig + 8);
  uint8_t ihdr[13];
  for (int s = 0; s < 4; ++s) {
    ihdr[s] = (w >> (24 - 8 * s)) & 0xff;
    ihdr[4 + s] = (h >> (24 - 8 * s)) & 0xff;
  }
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // color type: RGB
  ihdr[10] = 0;  // compression
  ihdr[11] = 0;  // filter
  ihdr[12] = 0;  // interlace
  put_chunk(png, "IHDR", ihdr, 13);
  put_chunk(png, "IDAT", idat.data(), idat.size());
  put_chunk(png, "IEND", nullptr, 0);
  return true;
}

bool write_png_rgb8(const std::string& path, const uint8_t* rgb, int h, int w, int level) {
  std::vector<uint8_t> png;
  if (!encode_png_rgb8(rgb, h, w, level, png)) return false;
  FILE* f = std::fopen(path.c_str(), "wb");
  if (!f) return false;
  size_t written = std::fwrite(png.data(), 1, png.size(), f);
  bool ok = std::fclose(f) == 0 && written == png.size();
  return ok;
}

// matplotlib's viridis, exact 256-entry LUT.
const uint8_t kViridis256[256][3] = {
    {68, 1, 84}, {68, 2, 86}, {69, 4, 87}, {69, 5, 89}, {70, 7, 90}, {70, 8, 92}, {70, 10, 93}, {70, 11, 94},
    {71, 13, 96}, {71, 14, 97}, {71, 16, 99}, {71, 17, 100}, {71, 19, 101}, {72, 20, 103}, {72, 22, 104}, {72, 23, 105},
    {72, 24, 106}, {72, 26, 108}, {72, 27, 109}, {72, 28, 110}, {72, 29, 111}, {72, 31, 112}, {72, 32, 113}, {72, 33, 115},
    {72, 35, 116}, {72, 36, 117}, {72, 37, 118}, {72, 38, 119}, {72, 40, 120}, {72, 41, 121}, {71, 42, 122}, {71, 44, 122},
    {71, 45, 123}, {71, 46, 124}, {71, 47, 125}, {70, 48, 126}, {70, 50, 126}, {70, 51, 127}, {70, 52, 128}, {69, 53, 129},
    {69, 55, 129}, {69, 56, 130}, {68, 57, 131}, {68, 58, 131}, {68, 59, 132}, {67, 61, 132}, {67, 62, 133}, {66, 63, 133},
    {66, 64, 134}, {66, 65, 134}, {65, 66, 135}, {65, 68, 135}, {64, 69, 136}, {64, 70, 136}, {63, 71, 136}, {63, 72, 137},
    {62, 73, 137}, {62, 74, 137}, {62, 76, 138}, {61, 77, 138}, {61, 78, 138}, {60, 79, 138}, {60, 80, 139}, {59, 81, 139},
    {59, 82, 139}, {58, 83, 139}, {58, 84, 140}, {57, 85, 140}, {57, 86, 140}, {56, 88, 140}, {56, 89, 140}, {55, 90, 140},
    {55, 91, 141}, {54, 92, 141}, {54, 93, 141}, {53, 94, 141}, {53, 95, 141}, {52, 96, 141}, {52, 97, 141}, {51, 98, 141},
    {51, 99, 141}, {50, 100, 142}, {50, 101, 142}, {49, 102, 142}, {49, 103, 142}, {49, 104, 142}, {48, 105, 142}, {48, 106, 142},
    {47, 107, 142}, {47, 108, 142}, {46, 109, 142}, {46, 110, 142}, {46, 111, 142}, {45, 112, 142}, {45, 113, 142}, {44, 113, 142},
    {44, 114, 142}, {44, 115, 142}, {43, 116, 142}, {43, 117, 142}, {42, 118, 142}, {42, 119, 142}, {42, 120, 142}, {41, 121, 142},
    {41, 122, 142}, {41, 123, 142}, {40, 124, 142}, {40, 125, 142}, {39, 126, 142}, {39, 127, 142}, {39, 128, 142}, {38, 129, 142},
    {38, 130, 142}, {38, 130, 142}, {37, 131, 142}, {37, 132, 142}, {37, 133, 142}, {36, 134, 142}, {36, 135, 142}, {35, 136, 142},
    {35, 137, 142}, {35, 138, 141}, {34, 139, 141}, {34, 140, 141}, {34, 141, 141}, {33, 142, 141}, {33, 143, 141}, {33, 144, 141},
    {33, 145, 140}, {32, 146, 140}, {32, 146, 140}, {32, 147, 140}, {31, 148, 140}, {31, 149, 139}, {31, 150, 139}, {31, 151, 139},
    {31, 152, 139}, {31, 153, 138}, {31, 154, 138}, {30, 155, 138}, {30, 156, 137}, {30, 157, 137}, {31, 158, 137}, {31, 159, 136},
    {31, 160, 136}, {31, 161, 136}, {31, 161, 135}, {31, 162, 135}, {32, 163, 134}, {32, 164, 134}, {33, 165, 133}, {33, 166, 133},
    {34, 167, 133}, {34, 168, 132}, {35, 169, 131}, {36, 170, 131}, {37, 171, 130}, {37, 172, 130}, {38, 173, 129}, {39, 173, 129},
    {40, 174, 128}, {41, 175, 127}, {42, 176, 127}, {44, 177, 126}, {45, 178, 125}, {46, 179, 124}, {47, 180, 124}, {49, 181, 123},
    {50, 182, 122}, {52, 182, 121}, {53, 183, 121}, {55, 184, 120}, {56, 185, 119}, {58, 186, 118}, {59, 187, 117}, {61, 188, 116},
    {63, 188, 115}, {64, 189, 114}, {66, 190, 113}, {68, 191, 112}, {70, 192, 111}, {72, 193, 110}, {74, 193, 109}, {76, 194, 108},
    {78, 195, 107}, {80, 196, 106}, {82, 197, 105}, {84, 197, 104}, {86, 198, 103}, {88, 199, 101}, {90, 200, 100}, {92, 200, 99},
    {94, 201, 98}, {96, 202, 96}, {99, 203, 95}, {101, 203, 94}, {103, 204, 92}, {105, 205, 91}, {108, 205, 90}, {110, 206, 88},
    {112, 207, 87}, {115, 208, 86}, {117, 208, 84}, {119, 209, 83}, {122, 209, 81}, {124, 210, 80}, {127, 211, 78}, {129, 211, 77},
    {132, 212, 75}, {134, 213, 73}, {137, 213, 72}, {139, 214, 70}, {142, 214, 69}, {144, 215, 67}, {147, 215, 65}, {149, 216, 64},
    {152, 216, 62}, {155, 217, 60}, {157, 217, 59}, {160, 218, 57}, {162, 218, 55}, {165, 219, 54}, {168, 219, 52}, {170, 220, 50},
    {173, 220, 48}, {176, 221, 47}, {178, 221, 45}, {181, 222, 43}, {184, 222, 41}, {186, 222, 40}, {189, 223, 38}, {192, 223, 37},
    {194, 223, 35}, {197, 224, 33}, {200, 224, 32}, {202, 225, 31}, {205, 225, 29}, {208, 225, 28}, {210, 226, 27}, {213, 226, 26},
    {216, 226, 25}, {218, 227, 25}, {221, 227, 24}, {223, 227, 24}, {226, 228, 24}, {229, 228, 25}, {231, 228, 25}, {234, 229, 26},
    {236, 229, 27}, {239, 229, 28}, {241, 229, 29}, {244, 230, 30}, {246, 230, 32}, {248, 230, 33}, {251, 231, 35}, {253, 231, 37},
};

// min-max normalized map -> viridis (or gray) RGB, rounding to the nearest
// of 256 levels; the range is that of the finite values, and a value that
// is not finite takes level 0
void colormap(const float* data, int n, bool viridis, uint8_t* rgb) {
  float lo = 0.0f, hi = 0.0f;
  bool any = false;
  for (int i = 0; i < n; ++i) {
    if (!std::isfinite(data[i])) continue;
    if (!any || data[i] < lo) lo = data[i];
    if (!any || data[i] > hi) hi = data[i];
    any = true;
  }
  float scale = (hi > lo) ? 255.0f / (hi - lo) : 0.0f;
  for (int i = 0; i < n; ++i) {
    float v = std::isfinite(data[i]) ? (data[i] - lo) * scale + 0.5f : 0.0f;
    int idx = v > 255.0f ? 255 : (v > 0.0f ? static_cast<int>(v) : 0);
    for (int c = 0; c < 3; ++c) rgb[i * 3 + c] = viridis ? kViridis256[idx][c] : static_cast<uint8_t>(idx);
  }
}

// ---------------------------------------------------------------------------
// Worker pool
// ---------------------------------------------------------------------------

class Writer {
 public:
  explicit Writer(int n_threads) {
    if (n_threads < 1) n_threads = 1;
    for (int i = 0; i < n_threads; ++i) threads_.emplace_back([this] { Run(); });
  }

  ~Writer() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) t.join();
  }

  void Submit(std::function<bool()> job) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      queue_.push_back(std::move(job));
    }
    cv_.notify_one();
  }

  int Pending() {
    std::unique_lock<std::mutex> lk(mu_);
    return static_cast<int>(queue_.size()) + active_;
  }

  // waits for every job; returns how many failed since the last flush
  int Flush() {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] { return queue_.empty() && active_ == 0; });
    int failed = failed_;
    failed_ = 0;
    return failed;
  }

 private:
  void Run() {
    for (;;) {
      std::function<bool()> job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
        if (stop_ && queue_.empty()) return;
        job = std::move(queue_.front());
        queue_.pop_front();
        ++active_;
      }
      bool ok = job();
      {
        std::unique_lock<std::mutex> lk(mu_);
        --active_;
        if (!ok) ++failed_;
        if (queue_.empty() && active_ == 0) done_cv_.notify_all();
      }
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::condition_variable done_cv_;
  std::deque<std::function<bool()>> queue_;
  std::vector<std::thread> threads_;
  bool stop_ = false;
  int active_ = 0;
  int failed_ = 0;
};

}  // namespace

extern "C" {

void* aw_create(int n_threads) { return new Writer(n_threads); }

void aw_destroy(void* h) { delete static_cast<Writer*>(h); }

// data: row-major float32 [h, w]; apply_viridis: 1 -> colormap, 0 -> gray
void aw_submit_gray(void* h, const float* data, int height, int width, const char* path, int apply_viridis,
                    int level) {
  std::vector<float> copy(data, data + static_cast<size_t>(height) * width);
  std::string p(path);
  static_cast<Writer*>(h)->Submit([copy = std::move(copy), p, height, width, apply_viridis, level]() {
    int n = height * width;
    std::vector<uint8_t> rgb(static_cast<size_t>(n) * 3);
    colormap(copy.data(), n, apply_viridis != 0, rgb.data());
    return write_png_rgb8(p, rgb.data(), height, width, level);
  });
}

// data: row-major uint8 [h, w, 3]
void aw_submit_rgb8(void* h, const uint8_t* data, int height, int width, const char* path, int level) {
  std::vector<uint8_t> copy(data, data + static_cast<size_t>(height) * width * 3);
  std::string p(path);
  static_cast<Writer*>(h)->Submit([copy = std::move(copy), p, height, width, level]() {
    return write_png_rgb8(p, copy.data(), height, width, level);
  });
}

int aw_write_rgb8(const uint8_t* data, int height, int width, const char* path, int level) {
  return write_png_rgb8(std::string(path), data, height, width, level) ? 1 : 0;
}

int aw_encode_rgb8(const uint8_t* data, int height, int width, int level, uint8_t** out, size_t* len) {
  std::vector<uint8_t> png;
  *out = nullptr;
  *len = 0;
  if (!encode_png_rgb8(data, height, width, level, png)) return 0;
  *out = static_cast<uint8_t*>(std::malloc(png.size()));
  if (*out == nullptr) return 0;
  std::memcpy(*out, png.data(), png.size());
  *len = png.size();
  return 1;
}

void aw_free(uint8_t* buffer) { std::free(buffer); }

int aw_pending(void* h) { return static_cast<Writer*>(h)->Pending(); }

int aw_flush(void* h) { return static_cast<Writer*>(h)->Flush(); }

}  // extern "C"
