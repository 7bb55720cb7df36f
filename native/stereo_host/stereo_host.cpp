// Native host runtime for stereo_match_traditional_tpu.
//
// Replacement for the reference's native L0 layer (OpenCV
// imread/cvtColor/copyMakeBorder/normalize/medianBlur used by every driver,
// e.g. SAD/SADmain.cpp:27-48, ASW/ASWeight.cpp:32-57, CBLSM/CBLSM.cpp:16-25):
// the device computes (JAX/XLA/Pallas); this library covers the host side —
// image decode, colorspace conversion, padding, display normalization and a
// multi-threaded pipelined pair loader that overlaps disk + prep with device
// compute.  Exposed over a C ABI for ctypes (no pybind11 in this image).
//
// Build: make (g++ -O3 -shared -fPIC -pthread).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// colorspace (matches utils/io.py, which matches OpenCV's 8-bit conventions)
// ---------------------------------------------------------------------------

// RGB -> gray, OpenCV weights 0.299/0.587/0.114 with round-to-nearest
// (reference converts every color input this way, `SADmain.cpp:39-40`).
void smt_rgb_to_gray_u8(const uint8_t* rgb, int64_t n_px, uint8_t* out) {
  for (int64_t i = 0; i < n_px; ++i) {
    const uint8_t* p = rgb + 3 * i;
    double g = 0.299 * p[0] + 0.587 * p[1] + 0.114 * p[2];
    out[i] = (uint8_t)std::min(255.0, std::max(0.0, std::round(g)));
  }
}

static inline double inv_gamma(double c) {
  return c > 0.04045 ? std::pow((c + 0.055) / 1.055, 2.4) : c / 12.92;
}

// RGB -> OpenCV 8-bit Lab (L*255/100, a+128, b+128, D65) — the ASW driver's
// `cvtColor(CV_BGR2Lab)` (`ASW/ASWeight.cpp:33-34`).
// OpenCV's FIXED-POINT u8 Lab path (RGB2Lab_b / initLabTabs in
// modules/imgproc/src/color.cpp): sRGB gamma LUT at 255*8 scale,
// cvRound'ed XYZ matrix at 1<<12 with D65-divided rows, cube-root LUT at
// 1<<15, descale-with-rounding — bit-identical to utils/io.rgb_to_lab_u8.
void smt_rgb_to_lab_u8(const uint8_t* rgb, int64_t n_px, uint8_t* out) {
  enum { kShift = 12, kGamma = 3, kShift2 = kShift + kGamma };
  static int32_t gamma_tab[256];
  static int32_t cbrt_tab[256 * 3 / 2 * (1 << kGamma)];
  static int64_t coef[3][3];
  static bool init = false;
  if (!init) {
    const double wp[3] = {0.950456, 1.0, 1.088754};
    const double m[3][3] = {{0.412453, 0.357580, 0.180423},
                            {0.212671, 0.715160, 0.072169},
                            {0.019334, 0.119193, 0.950227}};
    for (int i = 0; i < 256; ++i)
      gamma_tab[i] = (int32_t)std::nearbyint(255.0 * (1 << kGamma) *
                                             inv_gamma(i / 255.0));
    const int n = 256 * 3 / 2 * (1 << kGamma);
    for (int i = 0; i < n; ++i) {
      double t = i / (255.0 * (1 << kGamma));
      double f = t < 0.008856 ? t * 7.787 + 16.0 / 116.0 : std::cbrt(t);
      cbrt_tab[i] = (int32_t)std::nearbyint((1 << kShift2) * f);
    }
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        coef[i][j] = (int64_t)std::nearbyint(m[i][j] * (1 << kShift) / wp[i]);
    init = true;
  }
  const int64_t half = 1 << (kShift - 1), half2 = 1 << (kShift2 - 1);
  const int64_t l_scale = (116 * 255 + 50) / 100;
  const int64_t l_shift = -((16LL * 255 * (1 << kShift2) + 50) / 100);
  const int kTabMax = 256 * 3 / 2 * (1 << kGamma) - 1;
  for (int64_t i = 0; i < n_px; ++i) {
    const uint8_t* p = rgb + 3 * i;
    int64_t r = gamma_tab[p[0]], g = gamma_tab[p[1]], b = gamma_tab[p[2]];
    int64_t f[3];
    for (int k = 0; k < 3; ++k) {
      int64_t idx =
          (r * coef[k][0] + g * coef[k][1] + b * coef[k][2] + half) >> kShift;
      if (idx < 0) idx = 0;
      if (idx > kTabMax) idx = kTabMax;
      f[k] = cbrt_tab[idx];
    }
    int64_t L = (l_scale * f[1] + l_shift + half2) >> kShift2;
    int64_t a = (500 * (f[0] - f[1]) + (128LL << kShift2) + half2) >> kShift2;
    int64_t bb = (200 * (f[1] - f[2]) + (128LL << kShift2) + half2) >> kShift2;
    auto sat = [](int64_t v) -> uint8_t {
      return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
    };
    out[3 * i + 0] = sat(L);
    out[3 * i + 1] = sat(a);
    out[3 * i + 2] = sat(bb);
  }
}

// ---------------------------------------------------------------------------
// geometry / display
// ---------------------------------------------------------------------------

// copyMakeBorder(BORDER_REPLICATE) (`SAD/SADmain.cpp:47-48`).
void smt_replicate_pad_u8(const uint8_t* img, int h, int w, int pad,
                          uint8_t* out) {
  int wo = w + 2 * pad;
  for (int i = -pad; i < h + pad; ++i) {
    int si = std::min(std::max(i, 0), h - 1);
    uint8_t* row = out + (int64_t)(i + pad) * wo;
    uint8_t edge_l = img[(int64_t)si * w];
    uint8_t edge_r = img[(int64_t)si * w + w - 1];
    std::memset(row, edge_l, pad);
    std::memcpy(row + pad, img + (int64_t)si * w, w);
    std::memset(row + pad + w, edge_r, pad);
  }
}

// cv::normalize(NORM_MINMAX, 255) + convertTo(CV_8UC1) (`SAD/Sad.h:87-92`);
// non-finite values render as 0.
void smt_normalize_u8(const float* x, int64_t n, uint8_t* out) {
  float lo = 0, hi = 0;
  bool seen = false;
  for (int64_t i = 0; i < n; ++i) {
    float v = x[i];
    if (!std::isfinite(v)) continue;
    if (!seen) { lo = hi = v; seen = true; }
    else { lo = std::min(lo, v); hi = std::max(hi, v); }
  }
  double scale = (seen && hi > lo) ? 255.0 / (hi - lo) : 0.0;
  for (int64_t i = 0; i < n; ++i) {
    float v = x[i];
    out[i] = std::isfinite(v)
                 ? (uint8_t)std::min(255.0, std::max(0.0, std::round((v - lo) * scale)))
                 : 0;
  }
}

// medianBlur(3) prefilter (`CBLSM/CBLSM.cpp:24-25`), replicate borders.
void smt_median3_u8(const uint8_t* img, int h, int w, uint8_t* out) {
  for (int i = 0; i < h; ++i)
    for (int j = 0; j < w; ++j) {
      uint8_t v[9];
      int k = 0;
      for (int di = -1; di <= 1; ++di)
        for (int dj = -1; dj <= 1; ++dj) {
          int ii = std::min(std::max(i + di, 0), h - 1);
          int jj = std::min(std::max(j + dj, 0), w - 1);
          v[k++] = img[(int64_t)ii * w + jj];
        }
      std::nth_element(v, v + 4, v + 9);
      out[(int64_t)i * w + j] = v[4];
    }
}

// ---------------------------------------------------------------------------
// PGM/PPM codec (binary P5/P6) — the framework's native image format
// ---------------------------------------------------------------------------

static bool read_pnm_header(FILE* f, int* magic, int* w, int* h, int* maxval) {
  char m0 = fgetc(f), m1 = fgetc(f);
  if (m0 != 'P' || (m1 != '5' && m1 != '6')) return false;
  *magic = m1 - '0';
  int vals[3], got = 0;
  while (got < 3) {
    int c = fgetc(f);
    if (c == '#') { while (c != '\n' && c != EOF) c = fgetc(f); continue; }
    if (c == EOF) return false;
    if (c == ' ' || c == '\t' || c == '\n' || c == '\r') continue;
    int v = 0;
    while (c >= '0' && c <= '9') { v = v * 10 + (c - '0'); c = fgetc(f); }
    vals[got++] = v;
  }
  *w = vals[0]; *h = vals[1]; *maxval = vals[2];
  return *maxval > 0 && *maxval < 256;
}

// Returns 0 on success; fills h/w/channels. Pass probe=1 to read only the
// header (buffer untouched), then call again with an adequately sized buffer.
int smt_read_pnm(const char* path, uint8_t* buf, int64_t buf_size, int* h,
                 int* w, int* channels, int probe) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int magic, ww, hh, maxval;
  if (!read_pnm_header(f, &magic, &ww, &hh, &maxval)) { fclose(f); return -2; }
  int ch = magic == 5 ? 1 : 3;
  *h = hh; *w = ww; *channels = ch;
  if (probe) { fclose(f); return 0; }
  int64_t need = (int64_t)hh * ww * ch;
  if (buf_size < need) { fclose(f); return -3; }
  int64_t got = (int64_t)fread(buf, 1, need, f);
  fclose(f);
  return got == need ? 0 : -4;
}

int smt_write_pnm(const char* path, const uint8_t* buf, int h, int w,
                  int channels) {
  if (channels != 1 && channels != 3) return -1;
  FILE* f = fopen(path, "wb");
  if (!f) return -2;
  fprintf(f, "P%d\n%d %d\n255\n", channels == 1 ? 5 : 6, w, h);
  int64_t n = (int64_t)h * w * channels;
  int64_t put = (int64_t)fwrite(buf, 1, n, f);
  fclose(f);
  return put == n ? 0 : -3;
}

// ---------------------------------------------------------------------------
// PFM codec (float maps: Middlebury ground truth / disparity submissions —
// the dataset family the reference's hard-coded Teddy pair comes from,
// `SAD/SADmain.cpp:27-28`).  Mirrors utils/io.read_pfm/write_pfm.
// ---------------------------------------------------------------------------

// Returns 0 on success; fills h/w/channels (1 = "Pf", 3 = "PF").  Rows in
// buf are top-to-bottom (PFM stores bottom-to-top; this codec flips) and
// byte order is host order regardless of the file's endianness flag.
// Pass probe=1 to read only the header.
int smt_read_pfm(const char* path, float* buf, int64_t buf_size, int* h,
                 int* w, int* channels, int probe) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char magic[3] = {0, 0, 0};
  int ww = 0, hh = 0;
  if (fscanf(f, "%2s %d %d", magic, &ww, &hh) != 3 ||
      (strcmp(magic, "Pf") != 0 && strcmp(magic, "PF") != 0) || ww <= 0 ||
      hh <= 0) {
    fclose(f);
    return -2;
  }
  // Parse the scale token manually: fscanf("%lf") is locale-sensitive — a
  // comma-decimal LC_NUMERIC would parse '-1.0' as '-1', leave '.0'
  // unconsumed, and silently misalign the raster.  Only the
  // sign (endianness) and non-zero-ness of the scale matter here.
  char tok[64];
  int ti = 0, c;
  while ((c = fgetc(f)) != EOF && (c == ' ' || c == '\t' || c == '\n' || c == '\r')) {}
  for (; c != EOF && c != ' ' && c != '\t' && c != '\n' && c != '\r';
       c = fgetc(f)) {
    if (ti < 63) tok[ti++] = (char)c;
  }
  tok[ti] = 0;
  if (c != EOF) ungetc(c, f);
  bool neg = tok[0] == '-';
  bool nonzero = false, valid = ti > 0;
  for (int i = (tok[0] == '-' || tok[0] == '+') ? 1 : 0; tok[i]; ++i) {
    char d = tok[i];
    if (d >= '1' && d <= '9') nonzero = true;
    else if (d != '0' && d != '.' && d != ',') break;  // stop at exponent etc.
  }
  double scale = valid && nonzero ? (neg ? -1.0 : 1.0) : 0.0;
  if (scale == 0.0) {
    fclose(f);
    return -2;
  }
  // One whitespace byte terminates the scale token; tolerate a text-mode
  // CRLF pair (consuming only the '\r' would shift the raster one byte).
  if (fgetc(f) == '\r') {
    int c = fgetc(f);
    if (c != '\n' && c != EOF) ungetc(c, f);
  }
  int ch = magic[1] == 'f' ? 1 : 3;
  *h = hh; *w = ww; *channels = ch;
  if (probe) { fclose(f); return 0; }
  int64_t need = (int64_t)hh * ww * ch;
  if (buf_size < need) { fclose(f); return -3; }
  // bottom-to-top storage: read each raster row into its flipped slot
  for (int r = hh - 1; r >= 0; --r)
    if ((int64_t)fread(buf + (int64_t)r * ww * ch, sizeof(float), (size_t)ww * ch,
                       f) != (int64_t)ww * ch) {
      fclose(f);
      return -4;
    }
  fclose(f);
  const uint16_t one = 1;
  bool host_le = *(const uint8_t*)&one == 1;
  if ((scale < 0) != host_le) {  // file endianness != host: swap in place
    uint8_t* b = (uint8_t*)buf;
    for (int64_t i = 0; i < need; ++i) {
      std::swap(b[4 * i], b[4 * i + 3]);
      std::swap(b[4 * i + 1], b[4 * i + 2]);
    }
  }
  return 0;
}

// buf is top-to-bottom [h, w, channels] host-order floats; channels 1 or 3.
int smt_write_pfm(const char* path, const float* buf, int h, int w,
                  int channels) {
  if ((channels != 1 && channels != 3) || h <= 0 || w <= 0) return -1;
  FILE* f = fopen(path, "wb");
  if (!f) return -2;
  const uint16_t one = 1;
  bool host_le = *(const uint8_t*)&one == 1;
  // Fixed literal scale: fprintf("%f") is locale-sensitive (a comma-decimal
  // LC_NUMERIC would emit '-1,000000', unreadable by conforming parsers).
  fprintf(f, "P%c\n%d %d\n%s\n", channels == 1 ? 'f' : 'F',
          w, h, host_le ? "-1.0" : "1.0");
  for (int r = h - 1; r >= 0; --r)  // bottom-to-top
    if ((int64_t)fwrite(buf + (int64_t)r * w * channels, sizeof(float),
                        (size_t)w * channels, f) != (int64_t)w * channels) {
      fclose(f);
      return -3;
    }
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// threaded pair loader: decode + gray-convert on worker threads, ring buffer
// of ready pairs (pipelines host prep with device compute — the role OpenCV
// plays synchronously inside every reference main())
// ---------------------------------------------------------------------------

struct Pair {
  std::vector<uint8_t> left, right;
  int h = 0, w = 0;
  int64_t index = -1;
  int status = 0;  // 0 ok, <0 error
};

struct Loader {
  std::vector<std::pair<std::string, std::string>> items;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::queue<Pair> ready;
  std::atomic<int64_t> next_item{0};
  int64_t next_emit = 0;  // pairs are emitted in order
  size_t depth;
  bool stop = false;

  explicit Loader(size_t depth) : depth(depth) {}
};

static bool load_gray(const std::string& path, std::vector<uint8_t>& out,
                      int* h, int* w) {
  int ch = 0, hh = 0, ww = 0;
  if (smt_read_pnm(path.c_str(), nullptr, 0, &hh, &ww, &ch, 1) != 0) return false;
  std::vector<uint8_t> raw((size_t)hh * ww * ch);
  if (smt_read_pnm(path.c_str(), raw.data(), (int64_t)raw.size(), &hh, &ww, &ch,
                   0) != 0)
    return false;
  out.resize((size_t)hh * ww);
  if (ch == 1) out = std::move(raw);
  else smt_rgb_to_gray_u8(raw.data(), (int64_t)hh * ww, out.data());
  *h = hh; *w = ww;
  return true;
}

static void worker_main(Loader* L) {
  for (;;) {
    int64_t idx = L->next_item.fetch_add(1);
    if (idx >= (int64_t)L->items.size()) return;
    Pair p;
    p.index = idx;
    int hl = 0, wl = 0, hr = 0, wr = 0;
    bool ok = load_gray(L->items[idx].first, p.left, &hl, &wl) &&
              load_gray(L->items[idx].second, p.right, &hr, &wr) && hl == hr &&
              wl == wr;
    p.status = ok ? 0 : -1;
    p.h = hl; p.w = wl;
    std::unique_lock<std::mutex> lk(L->mu);
    // in-order emission: wait until it's this pair's turn and there is space
    L->cv_space.wait(lk, [&] {
      return L->stop || (p.index == L->next_emit && L->ready.size() < L->depth);
    });
    if (L->stop) return;
    L->ready.push(std::move(p));
    L->next_emit++;
    L->cv_ready.notify_all();
    L->cv_space.notify_all();
  }
}

void* smt_loader_create(const char** lefts, const char** rights, int64_t n,
                        int threads, int depth) {
  Loader* L = new Loader((size_t)std::max(1, depth));
  L->items.reserve(n);
  for (int64_t i = 0; i < n; ++i) L->items.emplace_back(lefts[i], rights[i]);
  int nt = std::max(1, threads);
  for (int t = 0; t < nt; ++t) L->workers.emplace_back(worker_main, L);
  return L;
}

// Blocks until the next pair (in submission order) is ready.  Returns 0 on
// success, 1 when exhausted, <0 on decode error for this pair.  On success
// the caller's buffers (each buf_size bytes) receive the gray images.
int smt_loader_next(void* handle, uint8_t* left, uint8_t* right,
                    int64_t buf_size, int* h, int* w) {
  Loader* L = (Loader*)handle;
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_ready.wait(lk, [&] {
    return !L->ready.empty() ||
           (L->next_emit >= (int64_t)L->items.size() && L->ready.empty());
  });
  if (L->ready.empty()) return 1;  // exhausted
  {
    // Capacity check BEFORE popping: an oversized pair stays queued so the
    // caller can retry with a bigger buffer instead of silently losing it
    // from the stream; *h/*w report the required geometry.  (Decode-error
    // pairs are popped below — the error is per-pair and final.)
    const Pair& front = L->ready.front();
    if (front.status == 0 && (int64_t)front.h * front.w > buf_size) {
      *h = front.h; *w = front.w;
      return -3;
    }
  }
  Pair p = std::move(L->ready.front());
  L->ready.pop();
  L->cv_space.notify_all();
  if (p.status != 0) return p.status;
  int64_t need = (int64_t)p.h * p.w;
  std::memcpy(left, p.left.data(), need);
  std::memcpy(right, p.right.data(), need);
  *h = p.h; *w = p.w;
  return 0;
}

void smt_loader_destroy(void* handle) {
  Loader* L = (Loader*)handle;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
  }
  L->cv_space.notify_all();
  L->cv_ready.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
