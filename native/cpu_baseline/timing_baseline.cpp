// Timed CPU baselines for ALL FIVE reference pipelines.
//
// Independent re-implementations (no code taken from the reference) of each
// project's ACTIVE path with the reference's PER-PIXEL LOOP STRUCTURE —
// including the work the reference re-does per (pixel, d), which is exactly
// what makes it slow and what the ">=10x vs CPU reference" north star is
// measured against:
//
//   sad       SAD/SADmain.cpp:66 (+Sad.h:96-139): per (i,j,d) 9x9 window
//             abs-diff sum; uniqueness WTA (Sad.h:40-85).
//   ncc       NCC/NCC_main.cpp:33 (+NCC.h:15-49): per (i,j,d) TWO full
//             21x21 passes (means, then var/cov) — the left-window stats
//             are recomputed for every d, as ComputeCost does.
//   asw       ASW/ASWeight.cpp:60-79 (+ASW.h:210-257,329-431): per (i,j,d)
//             both 25x25 weight masks built from the color LUT + space
//             mask (getColorMask/getGausssianMask), weighted truncated-AD
//             sum; L+R maps + the full post chain.
//   ad_census AD-CensusV1/main.cpp:58-84: fused AD+Census9x7 L+R, arm
//             growth, per-pixel O(arm^2) rectangle means, dual WTA (same
//             structure as ad_census_baseline.cpp, unified here).
//   cblsm     CBLSM/CBLSM.cpp:133-153: AD cost L+R, arms per image,
//             costAggregationV5 applied twice per volume (second right
//             pass reuses LEFT arms, CBLSM.cpp:150), per-pixel O(arm^2)
//             rectangle means, dual WTA.
//
// Threading matches the reference projects' .vcxproj settings: SAD, ASW
// and CBLSM enable OpenMP (SURVEY.md §5 — their committed pragmas race on
// shared reduction state; here the parallel-for is on the outer row loop
// only, so results are deterministic), NCC and AD-CensusV1 are
// single-threaded.  Pass threads=1 to force serial everywhere.
//
// Usage: ./timing_baseline <pipeline> [rows cols disp iters threads]
// Prints ONE JSON line: metric, MPixDisp/s (= rows*cols*disp / best-of-
// iters seconds — the same accounting as bench.py's device numerator),
// seconds, iters, threads, checksum.

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

int H, W, D;

inline int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// Replicate-padded read (copyMakeBorder(BORDER_REPLICATE) semantics).
inline float px(const std::vector<uint8_t>& img, int i, int j) {
  return float(img[size_t(clampi(i, 0, H - 1)) * W + clampi(j, 0, W - 1)]);
}

// Deterministic synthetic pair — identical generator to
// ad_census_baseline.cpp so arm-length statistics (which set the
// aggregation cost) match across the baseline binaries.
uint32_t rng_state = 123456789u;
inline uint32_t xorshift() {
  uint32_t x = rng_state;
  x ^= x << 13; x ^= x >> 17; x ^= x << 5;
  return rng_state = x;
}

void make_pair(std::vector<uint8_t>& L, std::vector<uint8_t>& R) {
  std::vector<uint8_t> tex(size_t(H) * (W + D));
  for (auto& v : tex) v = uint8_t(xorshift() % 256);
  for (int pass = 0; pass < 2; ++pass)
    for (int i = 0; i < H; ++i)
      for (int j = 1; j < W + D; ++j) {
        size_t k = size_t(i) * (W + D) + j;
        tex[k] = uint8_t((tex[k] + tex[k - 1]) / 2);
      }
  L.resize(size_t(H) * W);
  R.resize(size_t(H) * W);
  for (int i = 0; i < H; ++i)
    for (int j = 0; j < W; ++j) {
      int d = 2 + (j * (D / 4)) / W;
      L[size_t(i) * W + j] = tex[size_t(i) * (W + D) + j + D];
      int src = j + D - d;
      if (src < 0) src = 0;
      R[size_t(i) * W + j] = tex[size_t(i) * (W + D) + src];
    }
}

// ------------------------------------------------------------------ SAD

// Per-pixel SAD + uniqueness WTA, the reference's fused L1+L3 loop
// (GetPointDepthLeft): the d loop re-walks the full 9x9 window.
void run_sad(const std::vector<uint8_t>& L, const std::vector<uint8_t>& R,
             int winsize, float eps, std::vector<float>& disp) {
  int r = winsize + 1;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int i = 0; i < H; ++i) {
    std::vector<float> costs(D);
    for (int j = 0; j < W; ++j) {
      for (int d = 0; d < D; ++d) {
        int de = std::min(d, j);  // border: cost at last valid d
        float s = 0.0f;
        for (int oy = -r; oy <= r; ++oy)
          for (int ox = -r; ox <= r; ++ox)
            s += std::fabs(px(L, i + oy, j + ox) - px(R, i + oy, j + ox - de));
        costs[d] = s;
      }
      // uniqueness WTA (Sad.h:40-85 intended semantics)
      int best = 1;
      float bc = costs[1];
      for (int d = 2; d < D; ++d)
        if (costs[d] < bc) { bc = costs[d]; best = d; }
      float sec = costs[0];
      for (int d = 0; d < D; ++d)
        if (costs[d] != bc && costs[d] < sec) sec = costs[d];
      bool reject = (sec - bc <= eps) || best == 0 || best == D - 1;
      disp[size_t(i) * W + j] = reject ? 0.0f : float(best);
    }
  }
}

// ------------------------------------------------------------------ NCC

// Per-(pixel, d) NCC with TWO full window passes, mirroring ComputeCost
// (NCC.h:15-49): a mean pass over both windows, then a var/cov pass.
// The left-window statistics are recomputed for every d exactly as the
// reference does.  Single-threaded (NCC.vcxproj has no OpenMP).
void run_ncc(const std::vector<uint8_t>& L, const std::vector<uint8_t>& R,
             int w, std::vector<float>& disp) {
  double n = double(2 * w + 1) * (2 * w + 1);
  for (int i = 0; i < H; ++i)
    for (int j = 0; j < W; ++j) {
      size_t a = size_t(i) * W + j;
      disp[a] = 0.0f;
      bool interior = i >= w && i < H - w && j >= w && j < W - w;
      if (!interior) continue;
      int best = 0;
      double bestv = -2.0;
      for (int d = 0; d < D; ++d) {
        if (j - w - d < 0) continue;  // right window off the left edge
        // pass 1: means of both windows
        double sl = 0, sr = 0;
        for (int oy = -w; oy <= w; ++oy)
          for (int ox = -w; ox <= w; ++ox) {
            sl += px(L, i + oy, j + ox);
            sr += px(R, i + oy, j + ox - d);
          }
        double ml = sl / n, mr = sr / n;
        // pass 2: variances + covariance about the means
        double vl = 0, vr = 0, cov = 0;
        for (int oy = -w; oy <= w; ++oy)
          for (int ox = -w; ox <= w; ++ox) {
            double lv = px(L, i + oy, j + ox) - ml;
            double rv = px(R, i + oy, j + ox - d) - mr;
            vl += lv * lv; vr += rv * rv; cov += lv * rv;
          }
        if (vl <= 0.5 || vr <= 0.5) continue;  // flat window: never wins
        double ncc = cov / std::sqrt(vl * vr);
        if (ncc > bestv) { bestv = ncc; best = d; }
      }
      disp[a] = (bestv > -2.0) ? float(best) : 0.0f;
    }
}

// ------------------------------------------------------------------ ASW

// Per-(pixel, d) bilateral-weight cost with BOTH 25x25 masks built inside
// the d loop, mirroring bilateralfiterWight (ASW.h:210-257) called from
// AdaptiveSupportWeight's i/j/d loop (ASW.h:337-373).  Weights come from
// the precomputed 256-entry color LUT (getColorMask, ASW.h:41-47) times
// the precomputed Gaussian space mask (getGausssianMask, ASW.h:16-35).
void run_asw_volume_wta(const std::vector<uint8_t>& A,
                        const std::vector<uint8_t>& B, int radius,
                        const std::vector<float>& color_lut,
                        const std::vector<float>& space_mask, float trunc,
                        int dir, std::vector<float>& disp) {
  int wlen = 2 * radius + 1;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int i = 0; i < H; ++i) {
    std::vector<float> costs(D);
    for (int j = 0; j < W; ++j) {
      int lim = dir < 0 ? j : W - 1 - j;
      for (int d = 0; d < D; ++d) {
        if (d > lim) { costs[d] = costs[std::max(0, lim)]; continue; }
        int q = j + dir * d;  // match column in B
        float ca = px(A, i, j), cb = px(B, i, q);
        float num = 0.0f, den = 0.0f;
        for (int oy = -radius; oy <= radius; ++oy)
          for (int ox = -radius; ox <= radius; ++ox) {
            // both masks built per (pixel, d), as the reference does
            float va = px(A, i + oy, j + ox);
            float vb = px(B, i + oy, q + ox);
            float wa = color_lut[int(std::fabs(va - ca))] *
                       space_mask[size_t(oy + radius) * wlen + (ox + radius)];
            float wb = color_lut[int(std::fabs(vb - cb))] *
                       space_mask[size_t(oy + radius) * wlen + (ox + radius)];
            float e = std::fabs(va - vb);
            if (e > trunc) e = trunc;
            num += wa * wb * e;
            den += wa * wb;
          }
        costs[d] = num / std::max(den, 1e-20f);
      }
      int best = 0;
      float bc = costs[0];
      for (int d = 1; d < D; ++d)
        if (costs[d] < bc) { bc = costs[d]; best = d; }
      disp[size_t(i) * W + j] = float(best);
    }
  }
}

// Post chain pieces (ASWeight.cpp:66-78) — a trivial share of ASW runtime
// but part of the reference's wall clock, so timed too.
void lr_check_zero(std::vector<float>& dl, const std::vector<float>& dr,
                   float gate) {
  std::vector<float> out(dl.size());
  for (int i = 0; i < H; ++i)
    for (int j = 0; j < W; ++j) {
      size_t a = size_t(i) * W + j;
      int jr = clampi(j - int(dl[a]), 0, W - 1);
      out[a] = (std::fabs(dl[a] - dr[size_t(i) * W + jr]) > gate) ? 0.0f : dl[a];
    }
  dl.swap(out);
}

void speckles4(std::vector<float>& d, float max_diff, int min_area) {
  std::vector<int> label(d.size(), -1);
  std::vector<size_t> stack, comp;
  int next = 0;
  for (size_t s = 0; s < d.size(); ++s) {
    if (d[s] == 0.0f || label[s] >= 0) continue;
    stack.assign(1, s);
    comp.clear();
    label[s] = next;
    while (!stack.empty()) {
      size_t a = stack.back(); stack.pop_back();
      comp.push_back(a);
      int i = int(a / W), j = int(a % W);
      const int di[4] = {-1, 1, 0, 0}, dj[4] = {0, 0, -1, 1};
      for (int k = 0; k < 4; ++k) {
        int ii = i + di[k], jj = j + dj[k];
        if (ii < 0 || ii >= H || jj < 0 || jj >= W) continue;
        size_t b = size_t(ii) * W + jj;
        if (d[b] == 0.0f || label[b] >= 0) continue;
        if (std::fabs(d[a] - d[b]) <= max_diff) { label[b] = next; stack.push_back(b); }
      }
    }
    if (int(comp.size()) < min_area)
      for (size_t a : comp) d[a] = 0.0f;
    ++next;
  }
}

void median_replicate(std::vector<float>& d, int size) {
  int r = size / 2;
  std::vector<float> out(d.size());
  std::vector<float> win;
  for (int i = 0; i < H; ++i)
    for (int j = 0; j < W; ++j) {
      win.clear();
      for (int oy = -r; oy <= r; ++oy)
        for (int ox = -r; ox <= r; ++ox)
          win.push_back(d[size_t(clampi(i + oy, 0, H - 1)) * W + clampi(j + ox, 0, W - 1)]);
      std::nth_element(win.begin(), win.begin() + win.size() / 2, win.end());
      out[size_t(i) * W + j] = win[win.size() / 2];
    }
  d.swap(out);
}

void fill_image_new(std::vector<float>& d) {
  std::vector<float> out(d);
  for (int i = 0; i < H; ++i)
    for (int j = 0; j < W; ++j) {
      size_t a = size_t(i) * W + j;
      if (d[a] != 0.0f) continue;
      float v = 0.0f;
      for (int x = j - 1; x >= 0; --x)
        if (d[size_t(i) * W + x] != 0.0f) { v = d[size_t(i) * W + x]; break; }
      if (v == 0.0f)
        for (int x = j + 1; x < W; ++x)
          if (d[size_t(i) * W + x] != 0.0f) { v = d[size_t(i) * W + x]; break; }
      out[a] = v;
    }
  d.swap(out);
}

void minmax_u8(std::vector<float>& d) {
  float lo = d[0], hi = d[0];
  for (float v : d) { lo = std::min(lo, v); hi = std::max(hi, v); }
  float scale = hi > lo ? 255.0f / (hi - lo) : 0.0f;
  for (float& v : d) v = float(std::nearbyint((v - lo) * scale));
}

// ------------------------------------------------------- AD-Census / CBLSM

inline uint64_t census9x7(const std::vector<uint8_t>& img, int i, int j) {
  uint64_t code = 0;
  uint8_t c = img[size_t(i) * W + j];
  for (int r = -4; r <= 4; ++r)
    for (int q = -3; q <= 3; ++q) {
      code <<= 1;
      int ii = i + r, jj = j + q;
      if (ii < 0 || ii >= H || jj < 0 || jj >= W) continue;
      if (c > img[size_t(ii) * W + jj]) code |= 1;
    }
  return code;
}

inline int popcount64(uint64_t x) {
  int n = 0;
  while (x) { x &= x - 1; ++n; }  // Kernighan, as the reference uses
  return n;
}

void arms_grow(const std::vector<uint8_t>& img, int tao1, int tao2,
               int max_len, int sec_len, int di, int dj,
               std::vector<int>& arm) {
  for (int i = 0; i < H; ++i)
    for (int j = 0; j < W; ++j) {
      uint8_t c = img[size_t(i) * W + j];
      int len = 0;
      for (int o = 1; o <= max_len; ++o) {
        int ii = i + di * o, jj = j + dj * o;
        if (ii < 0 || ii >= H || jj < 0 || jj >= W) break;
        int tao = (o <= sec_len) ? tao1 : tao2;
        if (std::abs(int(img[size_t(ii) * W + jj]) - int(c)) > tao) break;
        len = o;
      }
      arm[size_t(i) * W + j] = len;
    }
}

// Per-pixel O(arm^2) rectangle mean — the reference's AggregationVertical /
// costAggregationV5 loop structure (CrossArm.cpp:60-102, CBLSM.h:1179-1224).
// omp_outer=true parallelizes the outer row loop (CBLSM enables OpenMP).
void rect_mean_loops(const std::vector<float>& vol, const std::vector<int>& al,
                     const std::vector<int>& ar, const std::vector<int>& au,
                     const std::vector<int>& ad_, bool omp_outer,
                     std::vector<float>& out) {
  for (int d = 0; d < D; ++d) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (omp_outer)
#endif
    for (int i = 0; i < H; ++i)
      for (int j = 0; j < W; ++j) {
        size_t a = size_t(i) * W + j;
        int up = au[a], dn = ad_[a], lf = al[a], rt = ar[a];
        float sum = 0.0f;
        for (int y = i - up; y <= i + dn; ++y)
          for (int x = j - lf; x <= j + rt; ++x)
            sum += vol[(size_t(y) * W + x) * D + d];
        out[a * D + d] = sum / float((up + dn + 1) * (lf + rt + 1));
      }
  }
}

void wta_min(const std::vector<float>& vol, std::vector<float>& out) {
  for (size_t a = 0; a < size_t(H) * W; ++a) {
    int best = 0;
    float bc = vol[a * D];
    for (int d = 1; d < D; ++d)
      if (vol[a * D + d] < bc) { bc = vol[a * D + d]; best = d; }
    out[a] = float(best);
  }
}

void fused_cost(const std::vector<uint8_t>& L, const std::vector<uint8_t>& R,
                const std::vector<uint64_t>& cenL,
                const std::vector<uint64_t>& cenR, double sigma_c,
                double sigma_s, bool left, std::vector<float>& vol) {
  for (int i = 0; i < H; ++i)
    for (int j = 0; j < W; ++j)
      for (int d = 0; d < D; ++d) {
        int jm = clampi(left ? j - d : j + d, 0, W - 1);
        size_t a = size_t(i) * W + j;
        size_t b = size_t(i) * W + jm;
        float ad = left ? std::fabs(float(L[a]) - float(R[b]))
                        : std::fabs(float(L[b]) - float(R[a]));
        int ham = left ? popcount64(cenL[a] ^ cenR[b])
                       : popcount64(cenL[b] ^ cenR[a]);
        vol[a * D + d] = float((1.0 - std::exp(-ad / sigma_c)) +
                               (1.0 - std::exp(-double(ham) / sigma_s)));
      }
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr,
            "usage: %s <sad|ncc|asw|ad_census|cblsm> [rows cols disp iters threads]\n",
            argv[0]);
    return 1;
  }
  std::string pipe = argv[1];
  H = 375; W = 450; D = (pipe == "ncc") ? 200 : 60;  // reference workloads
  int iters = (pipe == "ncc" || pipe == "asw") ? 1 : 3;
  if (argc >= 5) { H = atoi(argv[2]); W = atoi(argv[3]); D = atoi(argv[4]); }
  if (argc >= 6) iters = atoi(argv[5]);
#ifdef _OPENMP
  // reference enablement: OpenMP in SAD/ASW/CBLSM .vcxproj only
  bool ref_omp = (pipe == "sad" || pipe == "asw" || pipe == "cblsm");
  int threads = argc >= 7 ? atoi(argv[6]) : (ref_omp ? omp_get_max_threads() : 1);
  omp_set_num_threads(threads);
#else
  int threads = 1;
#endif

  std::vector<uint8_t> L, R;
  make_pair(L, R);
  size_t npx = size_t(H) * W;
  std::vector<float> dl(npx), dr(npx), fin;
  double best_s = 1e30;

  for (int it = 0; it < iters; ++it) {
    auto t0 = std::chrono::steady_clock::now();
    if (pipe == "sad") {
      run_sad(L, R, /*winsize=*/3, 0.01f, dl);
    } else if (pipe == "ncc") {
      run_ncc(L, R, /*win=*/10, dl);
    } else if (pipe == "asw") {
      // precomputed masks, as the driver builds once (ASWeight.cpp:48-51)
      int radius = 12;  // winSize=11 -> 25x25 window (2*winSize+3)
      int wlen = 2 * radius + 1;
      std::vector<float> lut(256), sp(size_t(wlen) * wlen);
      for (int k = 0; k < 256; ++k)
        lut[k] = float(std::exp(-double(k) * k / (2.0 * 30.0 * 30.0)));
      for (int oy = -radius; oy <= radius; ++oy)
        for (int ox = -radius; ox <= radius; ++ox)
          sp[size_t(oy + radius) * wlen + (ox + radius)] =
              float(std::exp(-(double(oy) * oy + double(ox) * ox) /
                             (2.0 * 50.0 * 50.0)));
      run_asw_volume_wta(L, R, radius, lut, sp, 40.0f, -1, dl);
      run_asw_volume_wta(R, L, radius, lut, sp, 40.0f, +1, dr);
      fin = dl;
      lr_check_zero(fin, dr, 5.0f);
      minmax_u8(fin);
      speckles4(fin, 2.0f, 41);
      median_replicate(fin, 5);
      fill_image_new(fin);
      median_replicate(fin, 3);
    } else if (pipe == "ad_census") {
      std::vector<uint64_t> cenL(npx), cenR(npx);
      for (int i = 0; i < H; ++i)
        for (int j = 0; j < W; ++j) {
          cenL[size_t(i) * W + j] = census9x7(L, i, j);
          cenR[size_t(i) * W + j] = census9x7(R, i, j);
        }
      std::vector<float> vol(npx * D), agg(npx * D);
      std::vector<int> al(npx), ar(npx), au(npx), ad_(npx);
      fused_cost(L, R, cenL, cenR, 10.0, 30.0, true, vol);
      arms_grow(L, 30, 6, 34, 17, 0, -1, al); arms_grow(L, 30, 6, 34, 17, 0, 1, ar);
      arms_grow(L, 30, 6, 34, 17, -1, 0, au); arms_grow(L, 30, 6, 34, 17, 1, 0, ad_);
      rect_mean_loops(vol, al, ar, au, ad_, false, agg);
      wta_min(agg, dl);
      fused_cost(L, R, cenL, cenR, 10.0, 30.0, false, vol);
      arms_grow(R, 30, 6, 34, 17, 0, -1, al); arms_grow(R, 30, 6, 34, 17, 0, 1, ar);
      arms_grow(R, 30, 6, 34, 17, -1, 0, au); arms_grow(R, 30, 6, 34, 17, 1, 0, ad_);
      rect_mean_loops(vol, al, ar, au, ad_, false, agg);
      wta_min(agg, dr);
    } else if (pipe == "cblsm") {
      std::vector<float> vol(npx * D), t(npx * D);
      std::vector<int> all(npx), alr(npx), alu(npx), ald(npx);
      std::vector<int> arl(npx), arr(npx), aru(npx), ard(npx);
      arms_grow(L, 25, 6, 34, 17, 0, -1, all); arms_grow(L, 25, 6, 34, 17, 0, 1, alr);
      arms_grow(L, 25, 6, 34, 17, -1, 0, alu); arms_grow(L, 25, 6, 34, 17, 1, 0, ald);
      arms_grow(R, 25, 6, 34, 17, 0, -1, arl); arms_grow(R, 25, 6, 34, 17, 0, 1, arr);
      arms_grow(R, 25, 6, 34, 17, -1, 0, aru); arms_grow(R, 25, 6, 34, 17, 1, 0, ard);
      for (int i = 0; i < H; ++i)
        for (int j = 0; j < W; ++j)
          for (int d = 0; d < D; ++d) {
            size_t a = size_t(i) * W + j;
            vol[a * D + d] = std::fabs(px(L, i, j) - px(R, i, clampi(j - d, 0, W - 1)));
          }
      rect_mean_loops(vol, all, alr, alu, ald, true, t);
      rect_mean_loops(t, all, alr, alu, ald, true, vol);
      wta_min(vol, dl);
      for (int i = 0; i < H; ++i)
        for (int j = 0; j < W; ++j)
          for (int d = 0; d < D; ++d) {
            size_t a = size_t(i) * W + j;
            vol[a * D + d] = std::fabs(px(L, i, clampi(j + d, 0, W - 1)) - px(R, i, j));
          }
      rect_mean_loops(vol, arl, arr, aru, ard, true, t);
      // second right pass reuses the LEFT arms (CBLSM.cpp:150 quirk)
      rect_mean_loops(t, all, alr, alu, ald, true, vol);
      wta_min(vol, dr);
    } else {
      fprintf(stderr, "unknown pipeline %s\n", pipe.c_str());
      return 1;
    }
    auto t1 = std::chrono::steady_clock::now();
    double s = std::chrono::duration<double>(t1 - t0).count();
    if (s < best_s) best_s = s;
  }

  double sum = 0;
  for (size_t k = 0; k < npx; ++k)
    sum += dl[k] + dr[k] + (fin.empty() ? 0.0f : fin[k]);
  double mpixdisp = npx * double(D) / best_s / 1e6;
  printf("{\"metric\": \"%s_cpu_baseline\", \"value\": %.3f, "
         "\"unit\": \"MPixDisp/s\", \"seconds\": %.3f, \"iters\": %d, "
         "\"threads\": %d, \"checksum\": %.0f}\n",
         pipe.c_str(), mpixdisp, best_s, iters, threads, sum);
  return 0;
}
