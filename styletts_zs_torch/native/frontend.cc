// Native host-side audio frontend: framing, energy, YIN-style F0.
//
// The reference repo ships no native code at all (SURVEY.md §0/§2.3); this
// library is the TPU-framework's own host-side data path: the serving loop
// and data-prep pipelines call it for per-utterance feature extraction so the
// Python process never burns GIL time in per-frame loops.  The algorithm
// matches styletts_zs_tpu/utils/audio.py (numpy reference) exactly — tests
// gate the two against each other.
//
// Build: make -C styletts_zs_tpu/native   (g++ -O3, no external deps)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

int64_t stz_n_frames(int64_t n_samples, int32_t frame_length, int32_t hop) {
  int64_t n = 1 + (n_samples - frame_length + hop - 1) / hop;
  return n < 1 ? 1 : n;
}

// Frame-level log-RMS energy; out must hold stz_n_frames() floats.
void stz_frame_energy(const float* wav, int64_t n_samples,
                      int32_t frame_length, int32_t hop, float* out) {
  int64_t n_frames = stz_n_frames(n_samples, frame_length, hop);
  for (int64_t i = 0; i < n_frames; ++i) {
    double acc = 0.0;
    int64_t start = i * hop;
    int64_t len = n_samples - start;
    if (len > frame_length) len = frame_length;
    if (len < 0) len = 0;
    for (int64_t j = 0; j < len; ++j) {
      double v = wav[start + j];
      acc += v * v;
    }
    double rms = std::sqrt(acc / frame_length);
    out[i] = static_cast<float>(std::log(rms > 1e-5 ? rms : 1e-5));
  }
}

// YIN-style F0 per frame.  f0_out/voiced_out must hold stz_n_frames() items.
void stz_estimate_f0(const float* wav, int64_t n_samples, int32_t sample_rate,
                     int32_t hop, int32_t frame_length, float fmin, float fmax,
                     float threshold, float* f0_out, uint8_t* voiced_out) {
  int64_t n_frames = stz_n_frames(n_samples, frame_length, hop);
  int32_t tau_min = static_cast<int32_t>(sample_rate / fmax);
  if (tau_min < 2) tau_min = 2;
  int32_t tau_max = static_cast<int32_t>(sample_rate / fmin);
  if (tau_max > frame_length - 2) tau_max = frame_length - 2;

  std::vector<double> x(frame_length);
  std::vector<double> d(tau_max + 1);
  std::vector<double> dn(tau_max + 1);

  for (int64_t i = 0; i < n_frames; ++i) {
    f0_out[i] = 0.0f;
    voiced_out[i] = 0;
    int64_t start = i * hop;
    double amax = 0.0;
    for (int32_t j = 0; j < frame_length; ++j) {
      int64_t idx = start + j;
      x[j] = (idx < n_samples) ? wav[idx] : 0.0;
      double a = std::fabs(x[j]);
      if (a > amax) amax = a;
    }
    if (amax < 1e-4) continue;

    // r0, suffix energies and linear autocorrelation (same formula as the
    // numpy reference: d(t) = r0 + sum_{j>=t} x_j^2 - 2*sum_j x_j x_{j+t})
    double r0 = 0.0;
    for (int32_t j = 0; j < frame_length; ++j) r0 += x[j] * x[j];
    double prefix = 0.0;  // sum_{j < t} x_j^2
    for (int32_t t = 0; t <= tau_max; ++t) {
      double corr = 0.0;
      for (int32_t j = 0; j + t < frame_length; ++j) corr += x[j] * x[j + t];
      double rt = r0 - prefix;
      d[t] = r0 + rt - 2.0 * corr;
      prefix += x[t] * x[t];
    }
    // cumulative-mean normalization
    dn[0] = 1.0;
    double run = 0.0;
    for (int32_t t = 1; t <= tau_max; ++t) {
      run += d[t];
      dn[t] = d[t] * t / (run > 1e-12 ? run : 1e-12);
    }
    // first dip under threshold in [tau_min, tau_max) walked to its local
    // minimum (YIN), else global min
    int32_t tau = -1;
    double best = 1e30;
    int32_t best_t = tau_min;
    for (int32_t t = tau_min; t < tau_max; ++t) {
      if (dn[t] < threshold) {
        tau = t;
        while (tau + 1 < tau_max && dn[tau + 1] < dn[tau]) ++tau;
        break;
      }
      if (dn[t] < best) { best = dn[t]; best_t = t; }
    }
    if (tau < 0) tau = best_t;
    if (dn[tau] < 0.5) {
      double tau_f = tau;
      if (tau >= 1 && tau < tau_max - 1) {
        double a = dn[tau - 1], b = dn[tau], c = dn[tau + 1];
        double denom = a - 2.0 * b + c;
        if (std::fabs(denom) > 1e-12) {
          double shift = 0.5 * (a - c) / denom;
          if (shift > 1.0) shift = 1.0;
          if (shift < -1.0) shift = -1.0;
          tau_f += shift;
        }
      }
      f0_out[i] = static_cast<float>(sample_rate / tau_f);
      voiced_out[i] = 1;
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Kaiser-windowed-sinc polyphase resampler (corpus loading: arbitrary WAV
// sample rates -> the model rate).  Math twin: utils/audio.py
// ``resample_poly_np`` — tests gate the two against each other exactly.
// ---------------------------------------------------------------------------

namespace {

// modified Bessel I0 via the power series (converges in < 40 terms for
// beta <= 20; matches np.i0 to ~1e-15 rel)
double bessel_i0(double x) {
  double sum = 1.0, term = 1.0;
  double x2 = x * x / 4.0;
  for (int k = 1; k < 64; ++k) {
    term *= x2 / (static_cast<double>(k) * k);
    sum += term;
    if (term < sum * 1e-18) break;
  }
  return sum;
}

int64_t gcd64(int64_t a, int64_t b) { return b == 0 ? a : gcd64(b, a % b); }

}  // namespace

extern "C" {

int64_t stz_resample_out_len(int64_t n, int32_t sr_in, int32_t sr_out) {
  int64_t g = gcd64(sr_in, sr_out);
  int64_t L = sr_out / g, M = sr_in / g;
  return (n * L + M - 1) / M;
}

// Rational L/M resampling with a Kaiser(beta)-windowed sinc low-pass of
// ``half`` zero crossings per branch.  y[j] = sum_q h[qL+p] x[b-q] with
// u = jM + center, p = u mod L, b = u div L  (zero-stuffed convolution,
// evaluated polyphase so each output costs ~2*half*max(1, M/L) madds).
void stz_resample_poly(const float* x, int64_t n, int32_t sr_in,
                       int32_t sr_out, int32_t half, double beta,
                       float* out) {
  int64_t g = gcd64(sr_in, sr_out);
  int64_t L = sr_out / g, M = sr_in / g;
  int64_t out_n = (n * L + M - 1) / M;
  if (L == M) {
    std::memcpy(out, x, sizeof(float) * n);
    return;
  }
  int64_t lm = L > M ? L : M;
  int64_t N = 2 * static_cast<int64_t>(half) * lm + 1;  // taps
  int64_t center = N / 2;
  double fc = 0.5 / static_cast<double>(lm);  // cycles/sample, upsampled grid
  std::vector<double> h(N);
  double i0b = bessel_i0(beta);
  for (int64_t i = 0; i < N; ++i) {
    double t = static_cast<double>(i - center);
    double s = (t == 0.0) ? 2.0 * fc
                          : std::sin(2.0 * M_PI * fc * t) / (M_PI * t);
    double r = t / static_cast<double>(center);
    double w = bessel_i0(beta * std::sqrt(std::max(0.0, 1.0 - r * r))) / i0b;
    h[i] = static_cast<double>(L) * s * w;
  }
  for (int64_t j = 0; j < out_n; ++j) {
    int64_t u = j * M + center;
    int64_t p = u % L;
    int64_t b = u / L;
    int64_t q_hi = (N - 1 - p) / L;
    double acc = 0.0;
    for (int64_t q = 0; q <= q_hi; ++q) {
      int64_t k = b - q;
      if (k < 0) break;
      if (k >= n) continue;
      acc += h[q * L + p] * static_cast<double>(x[k]);
    }
    out[j] = static_cast<float>(acc);
  }
}

}  // extern "C"
