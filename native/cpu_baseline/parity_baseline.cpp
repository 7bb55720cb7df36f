// Cross-implementation parity baseline: independent C++ re-implementations
// of the five ACTIVE reference paths and of the
// CANONICAL AD-Census family.
//
//   sad       SAD/SADmain.cpp:66        (left map, uniqueness WTA)
//   ncc       NCC/NCC_main.cpp:33       (interior argmax)
//   asw       ASW/ASWeight.cpp:60-79    (L+R + full post chain)
//   ad_census AD-CensusV1/main.cpp:58-84 (fused cost, arms, rect-mean, L+R)
//   cblsm     CBLSM/CBLSM.cpp:133-153   (AD cost, 2x rect-mean, L+R)
//   canonical    fused cost -> canonical arms (t1/t2/L1/L2,
//                cross_aggregator.cpp:135-269) -> iterative two-pass cross
//                aggregation with support counts (cross_aggregator.cpp:
//                89-118,271-394) -> tso-scheduled 4-path scanline
//                (adcensus_types.h:72 so_p1/so_p2/so_tso, Mei et al.
//                schedule) on BOTH volumes -> dual WTA -> canonical post
//                (rounded LR check PostProcessing.h:72-135, iterative
//                region voting irv_ts/irv_th, truncate median)
//   canonical_da same plus discontinuity adjustment (adcensus_types.h:74)
//
// Written independently — no code taken from the reference; plain per-pixel
// loops over flat arrays.  Semantics follow the *intended* behavior the
// framework implements (SURVEY.md §2 catalogues the reference's bugs that
// both sides deliberately fix: clamped borders instead of OOB reads, the
// census out-of-image zero bit, the right-arm col=_row fix, etc.).  The
// point of this program is that a SECOND, loop-structured implementation of
// the same spec agrees with the JAX engine on end-to-end disparity maps —
// the accuracy-parity evidence the engine's parity target asks for.
//
// Usage: parity_baseline <pipeline> <rows> <cols> <disp> <L.u8> <R.u8> <out_prefix>
//   Reads rows*cols uint8 per image; writes <out_prefix>.left.f32 (always),
//   .right.f32 (ad_census, cblsm, asw) and .final.f32 (asw) as row-major
//   float32 maps.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <string>
#include <vector>

namespace {

using std::size_t;

int H, W, D;

inline int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// Replicate-padded read of an [H, W] uint8 image.
inline float px(const std::vector<uint8_t>& img, int i, int j) {
  return float(img[size_t(clampi(i, 0, H - 1)) * W + clampi(j, 0, W - 1)]);
}

// ---------------------------------------------------------------------- WTA

// Plain argmin over d, first (lowest d) wins ties — jnp.argmin semantics
// and the reference's strict `<` trackers (AD-Census.h:346-380).
void wta_min(const std::vector<float>& vol, std::vector<float>& out) {
  for (size_t a = 0; a < size_t(H) * W; ++a) {
    int best = 0;
    float bc = vol[a * D];
    for (int d = 1; d < D; ++d)
      if (vol[a * D + d] < bc) { bc = vol[a * D + d]; best = d; }
    out[a] = float(best);
  }
}

// Uniqueness WTA (SAD/Sad.h:40-85 as reproduced by wta.optimal_disparity):
// argmin scan over d=1..D-1 (d=0 never wins), secMin = min over costs !=
// best cost seeded with cost[0]; reject to 0 when secMin-min <= eps or the
// best sits at either end of the range.  Subpixel is computed-and-discarded
// by the reference, so not computed here.
void wta_optimal(const std::vector<float>& vol, float eps,
                 std::vector<float>& out) {
  for (size_t a = 0; a < size_t(H) * W; ++a) {
    const float* c = &vol[a * D];
    int best = 1;
    float bc = c[1];
    for (int d = 2; d < D; ++d)
      if (c[d] < bc) { bc = c[d]; best = d; }
    float sec = c[0];  // seed (Sad.h:44)
    for (int d = 0; d < D; ++d)
      if (c[d] != bc && c[d] < sec) sec = c[d];
    bool reject = (sec - bc <= eps) || best == 0 || best == D - 1;
    out[a] = reject ? 0.0f : float(best);
  }
}

// ------------------------------------------------------------------- arms

struct Arms { std::vector<int> left, right, up, down; };

// Two-threshold arm growth (CrossArm.cpp:147-598 / CBLSM.h:536-966 as the
// framework implements it): offset o accepted iff in-bounds and
// |img(center) - img(center + o*dir)| <= tao(o) with tao = tao1 for
// o <= sec_len else tao2; arm = leading accepted count, capped at max_len;
// a threshold failure at o=1 still yields arm 1 when the pixel is >= 2 from
// the border in that direction (CrossArm.cpp:186-196).
void grow_arms(const std::vector<uint8_t>& img, int tao1, int tao2,
               int max_len, int sec_len, int di, int dj,
               std::vector<int>& arm) {
  for (int i = 0; i < H; ++i)
    for (int j = 0; j < W; ++j) {
      int c = img[size_t(i) * W + j];
      int len = 0;
      for (int o = 1; o <= max_len; ++o) {
        int ii = i + di * o, jj = j + dj * o;
        if (ii < 0 || ii >= H || jj < 0 || jj >= W) break;
        int tao = (o <= sec_len) ? tao1 : tao2;
        if (std::abs(int(img[size_t(ii) * W + jj]) - c) > tao) {
          if (o == 1) {
            // min-1 rule: >= 2 pixels of room toward this border
            int pos = di ? i : j, size = di ? H : W, sign = di ? di : dj;
            if ((sign < 0 && pos >= 2) || (sign > 0 && pos <= size - 3)) len = 1;
          }
          break;
        }
        len = o;
      }
      arm[size_t(i) * W + j] = len;
    }
}

Arms all_arms(const std::vector<uint8_t>& img, int tao1, int tao2,
              int max_len, int sec_len) {
  Arms a;
  size_t n = size_t(H) * W;
  a.left.resize(n); a.right.resize(n); a.up.resize(n); a.down.resize(n);
  grow_arms(img, tao1, tao2, max_len, sec_len, 0, -1, a.left);
  grow_arms(img, tao1, tao2, max_len, sec_len, 0, +1, a.right);
  grow_arms(img, tao1, tao2, max_len, sec_len, -1, 0, a.up);
  grow_arms(img, tao1, tao2, max_len, sec_len, +1, 0, a.down);
  return a;
}

// Inclusive arm-rectangle mean per disparity slice (AggregationVertical
// CrossArm.cpp:60-102 / costAggregationV5 CBLSM.h:1179-1224); O(1) per
// pixel via a per-slice summed-area table, like the framework.
void rect_mean(const std::vector<float>& vol, const Arms& arms,
               std::vector<float>& out) {
  std::vector<double> sat(size_t(H + 1) * (W + 1));
  std::vector<float> slice(size_t(H) * W);
  for (int d = 0; d < D; ++d) {
    for (int i = 0; i < H; ++i)
      for (int j = 0; j < W; ++j)
        slice[size_t(i) * W + j] = vol[(size_t(i) * W + j) * D + d];
    for (int i = 0; i < H; ++i)
      for (int j = 0; j < W; ++j)
        sat[size_t(i + 1) * (W + 1) + (j + 1)] =
            double(slice[size_t(i) * W + j]) + sat[size_t(i) * (W + 1) + (j + 1)] +
            sat[size_t(i + 1) * (W + 1) + j] - sat[size_t(i) * (W + 1) + j];
    for (int i = 0; i < H; ++i)
      for (int j = 0; j < W; ++j) {
        size_t a = size_t(i) * W + j;
        int y0 = i - arms.up[a], y1 = i + arms.down[a];
        int x0 = j - arms.left[a], x1 = j + arms.right[a];
        double sum = sat[size_t(y1 + 1) * (W + 1) + (x1 + 1)] -
                     sat[size_t(y0) * (W + 1) + (x1 + 1)] -
                     sat[size_t(y1 + 1) * (W + 1) + x0] +
                     sat[size_t(y0) * (W + 1) + x0];
        int cnt = (y1 - y0 + 1) * (x1 - x0 + 1);
        out[a * D + d] = float(sum / cnt);
      }
  }
}

// --------------------------------------------------------------- pipelines

// SAD active path: 9x9 windowed SAD (radius winsize+1, replicate pad,
// border d>j reads the d=j cost) -> uniqueness WTA, left map only.
void run_sad(const std::vector<uint8_t>& L, const std::vector<uint8_t>& R,
             int winsize, std::vector<float>& disp) {
  int r = winsize + 1;
  std::vector<float> vol(size_t(H) * W * D);
  for (int i = 0; i < H; ++i)
    for (int j = 0; j < W; ++j)
      for (int d = 0; d < D; ++d) {
        int de = std::min(d, j);  // border_fill: cost at last valid d
        float s = 0.0f;
        for (int oy = -r; oy <= r; ++oy)
          for (int ox = -r; ox <= r; ++ox)
            s += std::fabs(px(L, i + oy, j + ox) - px(R, i + oy, j + ox - de));
        vol[(size_t(i) * W + j) * D + d] = s;
      }
  wta_optimal(vol, 0.01f, disp);
}

// NCC active path: 21x21 window NCC in double, argmax (first max wins);
// pixels outside the interior loop bounds (NCC.h:72-75) and (d, j) entries
// whose right window crosses the left edge (NCC.h:81) never win; windows
// with zero variance divide 0/0 -> NaN which never wins (NCC.h:46,59).
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
      // left window stats
      double sl = 0, sl2 = 0;
      for (int oy = -w; oy <= w; ++oy)
        for (int ox = -w; ox <= w; ++ox) {
          double v = px(L, i + oy, j + ox) - 128.0;
          sl += v; sl2 += v * v;
        }
      double varl = sl2 - sl * sl / n;
      for (int d = 0; d < D; ++d) {
        if (j - w - d < 0) continue;  // invalid: right window off the edge
        double sr = 0, sr2 = 0, slr = 0;
        for (int oy = -w; oy <= w; ++oy)
          for (int ox = -w; ox <= w; ++ox) {
            double lv = px(L, i + oy, j + ox) - 128.0;
            double rv = px(R, i + oy, j + ox - d) - 128.0;
            sr += rv; sr2 += rv * rv; slr += lv * rv;
          }
        double varr = sr2 - sr * sr / n;
        if (varl <= 0.5 || varr <= 0.5) continue;  // flat: never wins
        double ncc = (slr - sl * sr / n) / std::sqrt(varl * varr);
        if (ncc > bestv) { bestv = ncc; best = d; }
      }
      disp[a] = (bestv > -2.0) ? float(best) : 0.0f;
    }
}

// ---------------------------------------------------------------- ASW

// Bilateral-weight truncated-AD cost (ASW.h:210-257,329-431 as the
// framework implements it): per offset o the left/right weight maps get
// one exp each; cost(p,d) = sum_o wL(p,o) wR(p-d,o) e(p,o,d) / sum_o w.
void asw_volume(const std::vector<uint8_t>& L, const std::vector<uint8_t>& R,
                int radius, double sigma_s, double sigma_c, double trunc,
                bool left_view, std::vector<float>& vol) {
  size_t npx = size_t(H) * W;
  std::vector<float> num(npx * D, 0.0f), den(npx * D, 0.0f);
  std::vector<float> wl(npx), wr(npx);
  double inv2sc = 1.0 / (2.0 * sigma_c * sigma_c);
  double inv2ss = 1.0 / (2.0 * sigma_s * sigma_s);
  const std::vector<uint8_t>& A = left_view ? L : R;  // fixed image
  const std::vector<uint8_t>& B = left_view ? R : L;  // moving image
  int dir = left_view ? -1 : +1;
  for (int oy = -radius; oy <= radius; ++oy)
    for (int ox = -radius; ox <= radius; ++ox) {
      float sp = float(std::exp(-(double(oy) * oy + double(ox) * ox) * inv2ss));
      for (int i = 0; i < H; ++i)
        for (int j = 0; j < W; ++j) {
          float da = px(A, i + oy, j + ox) - px(A, i, j);
          float db = px(B, i + oy, j + ox) - px(B, i, j);
          wl[size_t(i) * W + j] = float(std::exp(-double(da) * da * inv2sc)) * sp;
          wr[size_t(i) * W + j] = float(std::exp(-double(db) * db * inv2sc)) * sp;
        }
      for (int i = 0; i < H; ++i)
        for (int j = 0; j < W; ++j) {
          size_t a = size_t(i) * W + j;
          for (int d = 0; d < D; ++d) {
            int lim = left_view ? j : W - 1 - j;
            if (d > lim) continue;  // filled from d=lim afterwards
            int q = j + dir * d;    // match column (in range by the guard)
            float wgt = wl[a] * wr[size_t(i) * W + q];
            float e = std::fabs(px(A, i + oy, j + ox) - px(B, i + oy, j + ox + dir * d));
            if (e > trunc) e = float(trunc);
            num[a * D + d] += wgt * e;
            den[a * D + d] += wgt;
          }
        }
    }
  for (int i = 0; i < H; ++i)
    for (int j = 0; j < W; ++j) {
      size_t a = size_t(i) * W + j;
      int lim = left_view ? j : W - 1 - j;
      for (int d = 0; d < D; ++d) {
        int de = std::min(d, lim);
        vol[a * D + d] = num[a * D + de] / std::max(den[a * D + de], 1e-20f);
      }
    }
}

// LR check writing 0 (ASW.h:108-145): |dL(j) - dR(clamp(j - dL))| > gate.
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

// cv::normalize(0,255,NORM_MINMAX) + u8 convert kept as float
// (ASWeight.cpp:69-72); round half-to-even like jnp.round.
void minmax_u8(std::vector<float>& d) {
  float lo = d[0], hi = d[0];
  for (float v : d) { lo = std::min(lo, v); hi = std::max(hi, v); }
  float scale = hi > lo ? 255.0f / (hi - lo) : 0.0f;
  for (float& v : d) v = float(std::nearbyint((v - lo) * scale));
}

// Speckle filter, OpenCV filterSpeckles semantics as the framework maps
// them: members are pixels != 0, 4-connected when |diff| <= max_diff,
// components of size < min_area set to 0.
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

// Replicate-border window median (OpenCV medianBlur semantics:
// sorted[count/2] over the full (2r+1)^2 window).
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

// FillImageNew (ASW.h:434-511): zero pixels take the nearest non-zero to
// the left, else to the right, else 0 — all reads on the pre-fill map.
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

// ---------------------------------------------------------------- AD-Census

inline uint64_t census9x7(const std::vector<uint8_t>& img, int i, int j) {
  // center > neighbor, out-of-image bits 0 (AD-Census.h:166-192 intended
  // semantics; same packing order as the framework's census_transform)
  uint64_t code = 0;
  float c = px(img, i, j);
  for (int r = -4; r <= 4; ++r)
    for (int q = -3; q <= 3; ++q) {
      code <<= 1;
      int ii = i + r, jj = j + q;
      if (ii < 0 || ii >= H || jj < 0 || jj >= W) continue;
      if (c > px(img, ii, jj)) code |= 1;
    }
  return code;
}

void ad_census_volumes(const std::vector<uint8_t>& L,
                       const std::vector<uint8_t>& R, double sigma_c,
                       double sigma_s, std::vector<float>& volL,
                       std::vector<float>& volR) {
  size_t npx = size_t(H) * W;
  std::vector<uint64_t> cl(npx), cr(npx);
  for (int i = 0; i < H; ++i)
    for (int j = 0; j < W; ++j) {
      cl[size_t(i) * W + j] = census9x7(L, i, j);
      cr[size_t(i) * W + j] = census9x7(R, i, j);
    }
  for (int i = 0; i < H; ++i)
    for (int j = 0; j < W; ++j)
      for (int d = 0; d < D; ++d) {
        int jl = clampi(j - d, 0, W - 1), jr = clampi(j + d, 0, W - 1);
        size_t a = size_t(i) * W + j;
        float adl = std::fabs(px(L, i, j) - px(R, i, jl));
        float adr = std::fabs(px(L, i, jr) - px(R, i, j));
        int haml = __builtin_popcountll(cl[a] ^ cr[size_t(i) * W + jl]);
        int hamr = __builtin_popcountll(cl[size_t(i) * W + jr] ^ cr[a]);
        volL[a * D + d] = float((1.0 - std::exp(-adl / sigma_c)) +
                                (1.0 - std::exp(-haml / sigma_s)));
        volR[a * D + d] = float((1.0 - std::exp(-adr / sigma_c)) +
                                (1.0 - std::exp(-hamr / sigma_s)));
      }
}

// ------------------------------------------------- canonical AD-Census family
//
// Independent loop implementation of the canonical chain the framework
// runs for ADCensusConfig(aggregation='cross_two_pass'): the vendored
// CrossAggregator arm/aggregation rules (CBLSM/cross_aggregator.cpp),
// the tso-scheduled scanline the ADCensusOption so_* fields declare
// (CBLSM/adcensus_types.h:72, Mei et al. schedule), and the canonical
// post chain (rounded LR check AD-CensusV1/PostProcessing.h:72-135,
// iterative region voting irv_ts/irv_th, optional discontinuity
// adjustment, truncate median).

const float kInvalid = std::numeric_limits<float>::infinity();

// Canonical arm growth (cross_aggregator.cpp:135-269 rules): candidate at
// offset o extends the arm iff in bounds, |cand - center| < t1, for o > 1
// also |cand - previous| < t1, and for o > L2 additionally
// |cand - center| < t2; capped at L1.  No min-1 rule.
void grow_canonical_arms(const std::vector<uint8_t>& img, int t1, int t2,
                         int l1, int l2, int di, int dj,
                         std::vector<int>& arm) {
  for (int i = 0; i < H; ++i)
    for (int j = 0; j < W; ++j) {
      int c = img[size_t(i) * W + j];
      int prev = c, len = 0;
      for (int o = 1; o <= l1; ++o) {
        int ii = i + di * o, jj = j + dj * o;
        if (ii < 0 || ii >= H || jj < 0 || jj >= W) break;
        int cand = img[size_t(ii) * W + jj];
        if (std::abs(cand - c) >= t1) break;
        if (o > 1 && std::abs(cand - prev) >= t1) break;
        if (o > l2 && std::abs(cand - c) >= t2) break;
        len = o;
        prev = cand;
      }
      arm[size_t(i) * W + j] = len;
    }
}

Arms canonical_arms(const std::vector<uint8_t>& img, int t1, int t2, int l1,
                    int l2) {
  Arms a;
  size_t n = size_t(H) * W;
  a.left.resize(n); a.right.resize(n); a.up.resize(n); a.down.resize(n);
  grow_canonical_arms(img, t1, t2, l1, l2, 0, -1, a.left);
  grow_canonical_arms(img, t1, t2, l1, l2, 0, +1, a.right);
  grow_canonical_arms(img, t1, t2, l1, l2, -1, 0, a.up);
  grow_canonical_arms(img, t1, t2, l1, l2, +1, 0, a.down);
  return a;
}

// One horizontal arm-span pass: out(i,j,d) = sum_{s=-left..right} x(i,j+s,d)
// (arm bounds keep reads in range by construction).
void span_sum_h(const std::vector<float>& x, const Arms& arms,
                std::vector<float>& out) {
  for (int i = 0; i < H; ++i)
    for (int j = 0; j < W; ++j) {
      size_t a = size_t(i) * W + j;
      for (int d = 0; d < D; ++d) {
        double s = 0.0;
        for (int t = -arms.left[a]; t <= arms.right[a]; ++t)
          s += x[(a + t) * D + d];
        out[a * D + d] = float(s);
      }
    }
}

void span_sum_v(const std::vector<float>& x, const Arms& arms,
                std::vector<float>& out) {
  for (int i = 0; i < H; ++i)
    for (int j = 0; j < W; ++j) {
      size_t a = size_t(i) * W + j;
      for (int d = 0; d < D; ++d) {
        double s = 0.0;
        for (int t = -arms.up[a]; t <= arms.down[a]; ++t)
          s += x[(a + size_t(t) * W) * D + d];
        out[a * D + d] = float(s);
      }
    }
}

// 2-D span sums for the support counts (same shapes on a ones image).
void span2_h(const std::vector<float>& x, const Arms& arms,
             std::vector<float>& out) {
  for (int i = 0; i < H; ++i)
    for (int j = 0; j < W; ++j) {
      size_t a = size_t(i) * W + j;
      double s = 0.0;
      for (int t = -arms.left[a]; t <= arms.right[a]; ++t) s += x[a + t];
      out[a] = float(s);
    }
}

void span2_v(const std::vector<float>& x, const Arms& arms,
             std::vector<float>& out) {
  for (int i = 0; i < H; ++i)
    for (int j = 0; j < W; ++j) {
      size_t a = size_t(i) * W + j;
      double s = 0.0;
      for (int t = -arms.up[a]; t <= arms.down[a]; ++t)
        s += x[a + size_t(t) * W];
      out[a] = float(s);
    }
}

// Iterative two-pass cross aggregation (cross_aggregator.cpp:89-118,
// 327-394 as the framework implements it): per iteration sum along one
// axis inside the arm span, then along the other inside the arm span of
// the first-pass result, normalize by the matching support-pixel count,
// flip the pass order.  horizontal-first on iteration 0.
void cross_aggregate_canonical(std::vector<float>& vol, const Arms& arms,
                               int iters) {
  size_t npx = size_t(H) * W, nv = npx * D;
  std::vector<float> ones(npx, 1.0f), t2d(npx), sup_h(npx), sup_v(npx);
  span2_h(ones, arms, t2d);
  span2_v(t2d, arms, sup_h);
  span2_v(ones, arms, t2d);
  span2_h(t2d, arms, sup_v);
  std::vector<float> tmp(nv);
  bool hf = true;
  for (int it = 0; it < iters; ++it) {
    const std::vector<float>& sup = hf ? sup_h : sup_v;
    if (hf) {
      span_sum_h(vol, arms, tmp);
      span_sum_v(tmp, arms, vol);
    } else {
      span_sum_v(vol, arms, tmp);
      span_sum_h(tmp, arms, vol);
    }
    for (size_t a = 0; a < npx; ++a)
      for (int d = 0; d < D; ++d) vol[a * D + d] /= sup[a];
    hf = !hf;
  }
}

// Canonical tso penalty scale (adcensus_types.h:72 semantics, Mei et al.):
// D1 = |g1(p) - g1(p-r)| on the base image, D2 the same on the matched
// image at the per-d match column; both < tso -> 1.0, exactly one >= tso
// -> 0.25, both >= -> 0.1.
inline float tso_scale(float d1, float d2, float tso) {
  bool o1 = d1 >= tso, o2 = d2 >= tso;
  return (o1 && o2) ? 0.1f : ((o1 || o2) ? 0.25f : 1.0f);
}

// One directional canonical pass along (di, dj), accumulated into acc.
// Recurrence identical to the framework's _make_canonical_step: the
// path's first pixel keeps its cost; afterwards
//   out(d) = c(d) + min(prev(d), prev(d-1)+P1*s, prev(d+1)+P1*s,
//                       prev_min+P2*s) - prev_min
// with s the per-(pixel, d) tso scale vs the path predecessor.
void canonical_pass(const std::vector<float>& cost,
                    const std::vector<uint8_t>& base,
                    const std::vector<uint8_t>& match, bool left_view,
                    float p1, float p2, float tso, int di, int dj,
                    std::vector<double>& acc) {
  const float kBig = std::numeric_limits<float>::infinity();
  int dir = left_view ? -1 : +1;
  std::vector<float> prev(D), cur(D);
  // path starts: all pixels whose predecessor (i-di, j-dj) is outside
  for (int i0 = 0; i0 < H; ++i0)
    for (int j0 = 0; j0 < W; ++j0) {
      int pi = i0 - di, pj = j0 - dj;
      if (pi >= 0 && pi < H && pj >= 0 && pj < W) continue;  // mid-path
      int i = i0, j = j0;
      float prev_min = 0.0f;
      bool first = true;
      while (i >= 0 && i < H && j >= 0 && j < W) {
        size_t a = size_t(i) * W + j;
        if (first) {
          for (int d = 0; d < D; ++d) cur[d] = cost[a * D + d];
          first = false;
        } else {
          int ppi = i - di, ppj = j - dj;
          size_t pa = size_t(ppi) * W + ppj;
          float d1 = std::fabs(float(base[a]) - float(base[pa]));
          for (int d = 0; d < D; ++d) {
            float g2c = px(match, i, clampi(j + dir * d, 0, W - 1));
            float g2p = px(match, ppi, clampi(ppj + dir * d, 0, W - 1));
            float s = tso_scale(d1, std::fabs(g2c - g2p), tso);
            float l1 = prev[d];
            float l2 = (d > 0 ? prev[d - 1] : kBig) + p1 * s;
            float l3 = (d < D - 1 ? prev[d + 1] : kBig) + p1 * s;
            float l4 = prev_min + p2 * s;
            float m = std::min(std::min(l1, l2), std::min(l3, l4));
            cur[d] = cost[a * D + d] + m - prev_min;
          }
        }
        prev_min = cur[0];
        for (int d = 1; d < D; ++d) prev_min = std::min(prev_min, cur[d]);
        for (int d = 0; d < D; ++d) {
          acc[a * D + d] += cur[d];
          prev[d] = cur[d];
        }
        i += di; j += dj;
      }
    }
}

// 4-path canonical scanline: average of the four directional volumes.
void canonical_scanline(std::vector<float>& vol,
                        const std::vector<uint8_t>& base,
                        const std::vector<uint8_t>& match, bool left_view,
                        float p1, float p2, float tso) {
  std::vector<double> acc(vol.size(), 0.0);
  canonical_pass(vol, base, match, left_view, p1, p2, tso, 0, +1, acc);
  canonical_pass(vol, base, match, left_view, p1, p2, tso, 0, -1, acc);
  canonical_pass(vol, base, match, left_view, p1, p2, tso, +1, 0, acc);
  canonical_pass(vol, base, match, left_view, p1, p2, tso, -1, 0, acc);
  for (size_t k = 0; k < vol.size(); ++k) vol[k] = float(acc[k] * 0.25);
}

// Canonical rounded LR check (PostProcessing.h:72-135 as the framework's
// lr_check_consistency): col_right = trunc(j - dL + 0.5), out of range or
// |dL - dR| > gate -> kInvalid.
void lr_check_canonical(std::vector<float>& dl, const std::vector<float>& dr,
                        float gate) {
  std::vector<float> out(dl.size());
  for (int i = 0; i < H; ++i)
    for (int j = 0; j < W; ++j) {
      size_t a = size_t(i) * W + j;
      int cr = int(std::trunc(float(j) - dl[a] + 0.5f));
      bool in_range = cr >= 0 && cr < W;
      float drv = dr[size_t(i) * W + clampi(cr, 0, W - 1)];
      bool bad = in_range && std::fabs(dl[a] - drv) > gate;
      out[a] = (bad || !in_range) ? kInvalid : dl[a];
    }
  dl.swap(out);
}

// Iterative region voting (irv_ts/irv_th, adcensus_types.h:73 as the
// framework's iterative_region_voting): per iteration every invalid pixel
// histograms the valid integer disparities over its two-pass cross region
// (rows i-up(i,j)..i+down(i,j), each row spanning the arms of (r, j));
// filled when total > ts and the plurality bin > th * total (first-max).
void region_voting(std::vector<float>& d, const Arms& arms, float ts,
                   float th, int iters) {
  std::vector<float> out(d.size());
  std::vector<int> hist(D);
  for (int it = 0; it < iters; ++it) {
    for (int i = 0; i < H; ++i)
      for (int j = 0; j < W; ++j) {
        size_t a = size_t(i) * W + j;
        out[a] = d[a];
        if (d[a] != kInvalid) continue;
        std::fill(hist.begin(), hist.end(), 0);
        int total = 0;
        for (int t = -arms.up[a]; t <= arms.down[a]; ++t) {
          size_t ra = a + size_t(t) * W;
          for (int s = -arms.left[ra]; s <= arms.right[ra]; ++s) {
            float v = d[ra + s];
            if (v == kInvalid) continue;
            int b = int(std::nearbyint(v));
            if (b >= 0 && b < D) { ++hist[b]; ++total; }
          }
        }
        int best = 0, bestv = -1;
        for (int b = 0; b < D; ++b)
          if (hist[b] > bestv) { bestv = hist[b]; best = b; }
        if (total > ts && float(bestv) > th * float(total))
          out[a] = float(best);
      }
    d.swap(out);
  }
}

// Discontinuity adjustment (adcensus_types.h:74 as the framework's
// discontinuity_adjustment): at horizontal discontinuities (> 1 vs a
// valid neighbor) take whichever neighbor disparity has the lower
// aggregated cost at this pixel, if lower than the pixel's own.
void discontinuity_adjust(std::vector<float>& d,
                          const std::vector<float>& vol) {
  std::vector<float> out(d);
  for (int i = 0; i < H; ++i)
    for (int j = 0; j < W; ++j) {
      size_t a = size_t(i) * W + j;
      float self = d[a];
      bool valid = self != kInvalid;
      float ln = d[size_t(i) * W + clampi(j - 1, 0, W - 1)];
      float rn = d[size_t(i) * W + clampi(j + 1, 0, W - 1)];
      bool lok = valid && ln != kInvalid;
      bool rok = valid && rn != kInvalid;
      bool edge = (lok && std::fabs(self - ln) > 1.0f) ||
                  (rok && std::fabs(self - rn) > 1.0f);
      if (!edge) continue;
      auto cost_at = [&](float dv, bool ok) {
        if (!ok) return kInvalid;
        int idx = clampi(int(std::nearbyint(dv)), 0, D - 1);
        return vol[a * D + idx];
      };
      float cs = cost_at(self, valid);
      float cl = cost_at(ln, lok);
      float crr = cost_at(rn, rok);
      float best = self, bestc = cs;
      if (cl < bestc) { best = ln; bestc = cl; }
      if (crr < bestc) { best = rn; }
      out[a] = best;
    }
  d.swap(out);
}

// Truncate-border window median (PostProcessing.h:314-344 semantics as
// the framework's median_filter(border='truncate')): only in-bounds
// values participate, median = sorted[count / 2].
void median_truncate(std::vector<float>& d, int size) {
  int r = size / 2;
  std::vector<float> out(d.size());
  std::vector<float> win;
  for (int i = 0; i < H; ++i)
    for (int j = 0; j < W; ++j) {
      win.clear();
      for (int oy = -r; oy <= r; ++oy)
        for (int ox = -r; ox <= r; ++ox) {
          int ii = i + oy, jj = j + ox;
          if (ii < 0 || ii >= H || jj < 0 || jj >= W) continue;
          win.push_back(d[size_t(ii) * W + jj]);
        }
      std::sort(win.begin(), win.end());
      out[size_t(i) * W + j] = win[win.size() / 2];
    }
  d.swap(out);
}

void write_map(const std::string& path, const std::vector<float>& m) {
  FILE* f = fopen(path.c_str(), "wb");
  if (!f) { perror(path.c_str()); exit(2); }
  fwrite(m.data(), sizeof(float), m.size(), f);
  fclose(f);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 8) {
    fprintf(stderr,
            "usage: %s <sad|ncc|asw|ad_census|cblsm> rows cols disp L.u8 R.u8 out_prefix\n",
            argv[0]);
    return 1;
  }
  std::string pipe = argv[1];
  H = atoi(argv[2]); W = atoi(argv[3]); D = atoi(argv[4]);
  size_t npx = size_t(H) * W;
  std::vector<uint8_t> L(npx), R(npx);
  FILE* f = fopen(argv[5], "rb");
  if (!f || fread(L.data(), 1, npx, f) != npx) { perror("L"); return 2; }
  fclose(f);
  f = fopen(argv[6], "rb");
  if (!f || fread(R.data(), 1, npx, f) != npx) { perror("R"); return 2; }
  fclose(f);
  std::string out = argv[7];

  std::vector<float> dl(npx), dr(npx);
  if (pipe == "sad") {
    run_sad(L, R, /*winsize=*/3, dl);
    write_map(out + ".left.f32", dl);
  } else if (pipe == "ncc") {
    run_ncc(L, R, /*win=*/10, dl);
    write_map(out + ".left.f32", dl);
  } else if (pipe == "asw") {
    size_t nv = npx * D;
    std::vector<float> vol(nv);
    asw_volume(L, R, /*radius=*/12, 50.0, 30.0, 40.0, true, vol);
    wta_min(vol, dl);
    asw_volume(L, R, 12, 50.0, 30.0, 40.0, false, vol);
    wta_min(vol, dr);
    write_map(out + ".left.f32", dl);
    write_map(out + ".right.f32", dr);
    // post chain (ASWeight.cpp:66-78): LR->minmax->speckles->median5->fill->median3
    std::vector<float> fin(dl);
    lr_check_zero(fin, dr, 5.0f);
    minmax_u8(fin);
    speckles4(fin, 2.0f, 41);
    median_replicate(fin, 5);
    fill_image_new(fin);
    median_replicate(fin, 3);
    write_map(out + ".final.f32", fin);
  } else if (pipe == "ad_census") {
    size_t nv = npx * D;
    std::vector<float> volL(nv), volR(nv), agg(nv);
    ad_census_volumes(L, R, 10.0, 30.0, volL, volR);
    Arms al = all_arms(L, 30, 6, 34, 17);
    Arms ar = all_arms(R, 30, 6, 34, 17);
    rect_mean(volL, al, agg); wta_min(agg, dl);
    rect_mean(volR, ar, agg); wta_min(agg, dr);
    write_map(out + ".left.f32", dl);
    write_map(out + ".right.f32", dr);
  } else if (pipe == "canonical" || pipe == "canonical_da") {
    // ADCensusOption parameter set (CBLSM/adcensus_types.h:45-75):
    // lambda_ad 10, lambda_census 30, t1/t2 20/6, L1/L2 34/17,
    // so_p1/so_p2/so_tso 1/3/15, lrcheck 1.0, irv_ts/irv_th 20/0.4,
    // 4 aggregation iterations (CBLSM.cpp:142).
    size_t nv = npx * D;
    std::vector<float> volL(nv), volR(nv);
    ad_census_volumes(L, R, 10.0, 30.0, volL, volR);
    Arms al = canonical_arms(L, 20, 6, 34, 17);
    Arms ar = canonical_arms(R, 20, 6, 34, 17);
    cross_aggregate_canonical(volL, al, 4);
    cross_aggregate_canonical(volR, ar, 4);
    canonical_scanline(volL, L, R, true, 1.0f, 3.0f, 15.0f);
    canonical_scanline(volR, R, L, false, 1.0f, 3.0f, 15.0f);
    wta_min(volL, dl);
    wta_min(volR, dr);
    write_map(out + ".left.f32", dl);
    write_map(out + ".right.f32", dr);
    std::vector<float> fin(dl);
    lr_check_canonical(fin, dr, 1.0f);
    region_voting(fin, al, 20.0f, 0.4f, 5);
    if (pipe == "canonical_da") discontinuity_adjust(fin, volL);
    median_truncate(fin, 3);
    write_map(out + ".final.f32", fin);
  } else if (pipe == "cblsm") {
    size_t nv = npx * D;
    std::vector<float> volL(nv), volR(nv), t(nv);
    for (int i = 0; i < H; ++i)
      for (int j = 0; j < W; ++j)
        for (int d = 0; d < D; ++d) {
          size_t a = size_t(i) * W + j;
          volL[a * D + d] = std::fabs(px(L, i, j) - px(R, i, clampi(j - d, 0, W - 1)));
          volR[a * D + d] = std::fabs(px(L, i, clampi(j + d, 0, W - 1)) - px(R, i, j));
        }
    Arms al = all_arms(L, 25, 6, 34, 17);
    Arms ar = all_arms(R, 25, 6, 34, 17);
    // two passes; the right volume's SECOND pass reuses the LEFT arms
    // (CBLSM.cpp:150 quirk, kept by both implementations)
    rect_mean(volL, al, t); rect_mean(t, al, volL); wta_min(volL, dl);
    rect_mean(volR, ar, t); rect_mean(t, al, volR); wta_min(volR, dr);
    write_map(out + ".left.f32", dl);
    write_map(out + ".right.f32", dr);
  } else {
    fprintf(stderr, "unknown pipeline %s\n", pipe.c_str());
    return 1;
  }
  return 0;
}
