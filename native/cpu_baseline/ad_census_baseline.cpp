// CPU reference-equivalent baseline for the flagship AD-Census pipeline.
//
// Re-implements (independently — no code taken from the reference) the
// *active* path of AD-CensusV1/main.cpp:58-84: fused AD+Census cost volumes
// for both views, cross-arm growth, per-pixel arm-rectangle mean
// aggregation, dual WTA.  Same per-pixel loop structure and data layout
// ([row][col][disp]) as the reference so the measured MPix*disp/s is an
// honest stand-in for the unpublished upstream numbers.
//
// Single-threaded, like AD-CensusV1 as committed (its .vcxproj does not
// enable OpenMP; the pragmas in other projects are racy anyway, SURVEY §2).
//
// Usage: ./ad_census_baseline [rows cols disp iters]
// Prints one JSON line with the measured throughput.

#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>

namespace {

struct Params {
  int rows = 375, cols = 450, disp = 60;
  double sigma_c = 10.0, sigma_s = 30.0;
  int tao1 = 30, tao2 = 6, max_len = 34, sec_len = 17;
};

// xorshift PRNG for a deterministic synthetic pair (no file IO needed).
uint32_t rng_state = 123456789u;
inline uint32_t xorshift() {
  uint32_t x = rng_state;
  x ^= x << 13; x ^= x >> 17; x ^= x << 5;
  return rng_state = x;
}

void make_pair(std::vector<uint8_t>& L, std::vector<uint8_t>& R, int rows,
               int cols, int disp) {
  // Smooth-ish texture: random base + neighbor smoothing; right = left
  // shifted by a ramp disparity.
  std::vector<uint8_t> tex(static_cast<size_t>(rows) * (cols + disp));
  for (auto& v : tex) v = static_cast<uint8_t>(xorshift() % 256);
  for (int pass = 0; pass < 2; ++pass)
    for (int i = 0; i < rows; ++i)
      for (int j = 1; j < cols + disp; ++j) {
        size_t k = static_cast<size_t>(i) * (cols + disp) + j;
        tex[k] = static_cast<uint8_t>((tex[k] + tex[k - 1]) / 2);
      }
  L.resize(static_cast<size_t>(rows) * cols);
  R.resize(static_cast<size_t>(rows) * cols);
  for (int i = 0; i < rows; ++i)
    for (int j = 0; j < cols; ++j) {
      int d = 2 + (j * (disp / 4)) / cols;  // gentle ramp
      L[static_cast<size_t>(i) * cols + j] =
          tex[static_cast<size_t>(i) * (cols + disp) + j + disp];
      int src = j + disp - d;
      if (src < 0) src = 0;
      R[static_cast<size_t>(i) * cols + j] =
          tex[static_cast<size_t>(i) * (cols + disp) + src];
    }
}

inline uint64_t census9x7(const std::vector<uint8_t>& img, int rows, int cols,
                          int i, int j) {
  uint64_t code = 0;
  uint8_t c = img[static_cast<size_t>(i) * cols + j];
  for (int r = -4; r <= 4; ++r)
    for (int q = -3; q <= 3; ++q) {
      code <<= 1;
      int ii = i + r, jj = j + q;
      if (ii < 0 || ii >= rows || jj < 0 || jj >= cols) continue;
      if (c > img[static_cast<size_t>(ii) * cols + jj]) code |= 1;
    }
  return code;
}

inline int popcount64(uint64_t x) {
  int n = 0;
  while (x) { x &= x - 1; ++n; }  // Kernighan, as the reference uses
  return n;
}

void fused_cost(const std::vector<uint8_t>& L, const std::vector<uint8_t>& R,
                const std::vector<uint64_t>& cenL,
                const std::vector<uint64_t>& cenR, const Params& p, bool left,
                std::vector<float>& vol) {
  for (int i = 0; i < p.rows; ++i)
    for (int j = 0; j < p.cols; ++j)
      for (int d = 0; d < p.disp; ++d) {
        int jm = left ? j - d : j + d;
        if (jm < 0) jm = 0;
        if (jm >= p.cols) jm = p.cols - 1;
        size_t a = static_cast<size_t>(i) * p.cols + j;
        size_t b = static_cast<size_t>(i) * p.cols + jm;
        float ad = left ? std::fabs(float(L[a]) - float(R[b]))
                        : std::fabs(float(L[b]) - float(R[a]));
        int ham = left ? popcount64(cenL[a] ^ cenR[b])
                       : popcount64(cenL[b] ^ cenR[a]);
        float cost = (1.0f - std::exp(-ad / p.sigma_c)) +
                     (1.0f - std::exp(-float(ham) / p.sigma_s));
        vol[(a)*p.disp + d] = cost;
      }
}

void arms_grow(const std::vector<uint8_t>& img, const Params& p, int di,
               int dj, std::vector<int>& arm) {
  for (int i = 0; i < p.rows; ++i)
    for (int j = 0; j < p.cols; ++j) {
      uint8_t c = img[static_cast<size_t>(i) * p.cols + j];
      int len = 0;
      for (int o = 1; o <= p.max_len; ++o) {
        int ii = i + di * o, jj = j + dj * o;
        if (ii < 0 || ii >= p.rows || jj < 0 || jj >= p.cols) break;
        int tao = (o <= p.sec_len) ? p.tao1 : p.tao2;
        int diff = std::abs(int(img[static_cast<size_t>(ii) * p.cols + jj]) - int(c));
        if (diff > tao) break;
        len = o;
      }
      arm[static_cast<size_t>(i) * p.cols + j] = len;
    }
}

void rect_mean(const std::vector<float>& vol, const std::vector<int>& al,
               const std::vector<int>& ar, const std::vector<int>& au,
               const std::vector<int>& ad_, const Params& p,
               std::vector<float>& out) {
  // per-pixel O(arm^2) rectangle mean, matching the reference's
  // AggregationVertical loop structure (CrossArm.cpp:60-102)
  for (int d = 0; d < p.disp; ++d)
    for (int i = 0; i < p.rows; ++i)
      for (int j = 0; j < p.cols; ++j) {
        size_t a = static_cast<size_t>(i) * p.cols + j;
        int up = au[a], dn = ad_[a], lf = al[a], rt = ar[a];
        float sum = 0.0f;
        for (int y = i - up; y <= i + dn; ++y)
          for (int x = j - lf; x <= j + rt; ++x)
            sum += vol[(static_cast<size_t>(y) * p.cols + x) * p.disp + d];
        int cnt = (up + dn + 1) * (lf + rt + 1);
        out[a * p.disp + d] = sum / float(cnt);
      }
}

void wta(const std::vector<float>& vol, const Params& p,
         std::vector<float>& disp_map) {
  for (int i = 0; i < p.rows; ++i)
    for (int j = 0; j < p.cols; ++j) {
      size_t a = static_cast<size_t>(i) * p.cols + j;
      int best = 0;
      float bestc = vol[a * p.disp];
      for (int d = 1; d < p.disp; ++d)
        if (vol[a * p.disp + d] < bestc) { bestc = vol[a * p.disp + d]; best = d; }
      disp_map[a] = float(best);
    }
}

}  // namespace

int main(int argc, char** argv) {
  Params p;
  int iters = 3;
  if (argc >= 4) { p.rows = atoi(argv[1]); p.cols = atoi(argv[2]); p.disp = atoi(argv[3]); }
  if (argc >= 5) iters = atoi(argv[4]);

  std::vector<uint8_t> L, R;
  make_pair(L, R, p.rows, p.cols, p.disp);
  size_t npx = static_cast<size_t>(p.rows) * p.cols;

  std::vector<uint64_t> cenL(npx), cenR(npx);
  std::vector<float> volL(npx * p.disp), volR(npx * p.disp),
      aggL(npx * p.disp), aggR(npx * p.disp);
  std::vector<int> al(npx), ar(npx), au(npx), ad_(npx);
  std::vector<float> dispL(npx), dispR(npx);

  double best_s = 1e30;
  for (int it = 0; it < iters; ++it) {
    auto t0 = std::chrono::steady_clock::now();
    for (int i = 0; i < p.rows; ++i)
      for (int j = 0; j < p.cols; ++j) {
        cenL[static_cast<size_t>(i) * p.cols + j] = census9x7(L, p.rows, p.cols, i, j);
        cenR[static_cast<size_t>(i) * p.cols + j] = census9x7(R, p.rows, p.cols, i, j);
      }
    fused_cost(L, R, cenL, cenR, p, true, volL);
    fused_cost(L, R, cenL, cenR, p, false, volR);
    arms_grow(L, p, 0, -1, al); arms_grow(L, p, 0, 1, ar);
    arms_grow(L, p, -1, 0, au); arms_grow(L, p, 1, 0, ad_);
    rect_mean(volL, al, ar, au, ad_, p, aggL);
    wta(aggL, p, dispL);
    arms_grow(R, p, 0, -1, al); arms_grow(R, p, 0, 1, ar);
    arms_grow(R, p, -1, 0, au); arms_grow(R, p, 1, 0, ad_);
    rect_mean(volR, al, ar, au, ad_, p, aggR);
    wta(aggR, p, dispR);
    auto t1 = std::chrono::steady_clock::now();
    double s = std::chrono::duration<double>(t1 - t0).count();
    if (s < best_s) best_s = s;
  }
  // checksum so the work cannot be optimized away
  double sum = 0;
  for (size_t k = 0; k < npx; ++k) sum += dispL[k] + dispR[k];

  double mpixdisp = npx * double(p.disp) / best_s / 1e6;
  printf("{\"metric\": \"ad_census_cpu_baseline\", \"value\": %.3f, "
         "\"unit\": \"MPixDisp/s\", \"seconds\": %.3f, \"checksum\": %.0f}\n",
         mpixdisp, best_s, sum);
  return 0;
}
