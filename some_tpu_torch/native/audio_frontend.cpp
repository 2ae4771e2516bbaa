// The port's native host plane: RMS envelope, silence-slicer scan and the
// FIR decimator of the half-rate wire.
//
// A copy of some_tpu/native/audio_frontend.cpp with the same extern "C" ABI
// and the same arithmetic, so the port's host plane gives the JAX package's
// bits. Its plain versions are some_tpu_torch/audio/slicer.py (rms_envelope,
// scan_silence) and some_tpu_torch/audio/wavio.py (_decimate_fir).
//
// Built and bound by some_tpu_torch/native/__init__.py:
//   g++ -O3 -march=native -shared -fPIC audio_frontend.cpp -o build/libsome_audio-<key>.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Centered RMS per frame over a cumulative-sum-of-squares scan.
// y: [n] mono float32; out: [num_frames] float64 (caller-allocated,
// num_frames = (n + 2*(frame/2) - frame) / hop + 1).
void rms_envelope(const float* y, int64_t n, int64_t frame, int64_t hop,
                  double* out, int64_t num_frames) {
    const int64_t pad = frame / 2;
    const int64_t padded = n + 2 * pad;
    std::vector<double> csum(static_cast<size_t>(padded) + 1, 0.0);
    for (int64_t i = 0; i < padded; ++i) {
        const int64_t src = i - pad;
        const double v = (src >= 0 && src < n) ? static_cast<double>(y[src]) : 0.0;
        csum[i + 1] = csum[i] + v * v;
    }
    for (int64_t f = 0; f < num_frames; ++f) {
        const int64_t start = f * hop;
        out[f] = std::sqrt((csum[start + frame] - csum[start]) / frame);
    }
}

static int64_t argmin_range(const double* rms, int64_t lo, int64_t hi_incl,
                            int64_t total) {
    if (hi_incl >= total) hi_incl = total - 1;
    int64_t best = lo;
    for (int64_t i = lo + 1; i <= hi_incl; ++i)
        if (rms[i] < rms[best]) best = i;
    return best;
}

// Silence-slicer scan over an RMS envelope. Writes (start, end) frame pairs
// into tags (caller-allocated, capacity*2 entries); returns tag count.
// Mirrors some_tpu/audio/slicer.py::SilenceSlicer.slice state machine.
int64_t slicer_scan(const double* rms, int64_t total_frames, double threshold,
                    int64_t min_interval, int64_t min_length,
                    int64_t max_sil_kept, int64_t* tags, int64_t capacity) {
    int64_t count = 0;
    int64_t silence_start = -1;
    int64_t clip_start = 0;

    auto push = [&](int64_t a, int64_t b) {
        if (count < capacity) {
            tags[count * 2] = a;
            tags[count * 2 + 1] = b;
            ++count;
        }
    };

    for (int64_t i = 0; i < total_frames; ++i) {
        if (rms[i] < threshold) {
            if (silence_start < 0) silence_start = i;
            continue;
        }
        if (silence_start < 0) continue;

        const bool leading = (silence_start == 0) && (i > max_sil_kept);
        const bool middle = (i - silence_start >= min_interval) &&
                            (i - clip_start >= min_length);
        if (!leading && !middle) {
            silence_start = -1;
            continue;
        }
        if (i - silence_start <= max_sil_kept) {
            const int64_t pos = argmin_range(rms, silence_start, i, total_frames);
            if (silence_start == 0) push(0, pos); else push(pos, pos);
            clip_start = pos;
        } else if (i - silence_start <= max_sil_kept * 2) {
            const int64_t pos = argmin_range(
                rms, i - max_sil_kept, silence_start + max_sil_kept, total_frames);
            const int64_t pos_l = argmin_range(
                rms, silence_start, silence_start + max_sil_kept, total_frames);
            const int64_t pos_r = argmin_range(
                rms, i - max_sil_kept, i, total_frames);
            if (silence_start == 0) {
                push(0, pos_r);
                clip_start = pos_r;
            } else {
                const int64_t a = pos_l < pos ? pos_l : pos;
                const int64_t b = pos_r > pos ? pos_r : pos;
                push(a, b);
                clip_start = b;
            }
        } else {
            const int64_t pos_l = argmin_range(
                rms, silence_start, silence_start + max_sil_kept, total_frames);
            const int64_t pos_r = argmin_range(
                rms, i - max_sil_kept, i, total_frames);
            if (silence_start == 0) push(0, pos_r); else push(pos_l, pos_r);
            clip_start = pos_r;
        }
        silence_start = -1;
    }

    if (silence_start >= 0 && total_frames - silence_start >= min_interval) {
        int64_t silence_end = silence_start + max_sil_kept;
        if (silence_end > total_frames) silence_end = total_frames;
        const int64_t pos = argmin_range(rms, silence_start, silence_end,
                                         total_frames);
        push(pos, total_frames + 1);
    }
    return count;
}

// Polyphase FIR decimator for the half-rate audio wire (wire_sr config
// key; spec: some_tpu/audio/wavio.py::decimate_wire). Matches
// scipy.signal.resample_poly(x, 1, factor, window=taps) for ODD-length
// gain-1 taps: out[i] = sum_k taps[k] * xz[factor*i + k - half], where xz
// is x zero-extended on both sides and half = n_taps/2 (the filter's
// integer group delay, trimmed exactly). scipy's generic upfirdn loop
// measured ~0.16 GMAC/s on this host — too slow to ride the serving hot
// path; this interior loop auto-vectorizes to the machine's widest FMA.
// Structure: polyphase decomposition + output-blocked axpy. Writing the
// inner loop over OUTPUTS (contiguous loads, one FMA per lane, no
// cross-lane reduction) lets the compiler vectorize under strict FP
// semantics — a scalar-accumulator dot product is a serial dependency
// chain gcc will not reassociate (measured 1.8 s vs ~0.05 s for 180 s of
// audio). Zero taps (half of them for the factor-2 halfband design, whose
// ideal response has sinc zeros at even offsets) skip their pass entirely.
void decimate_fir(const float* x, int64_t n, const float* taps,
                  int64_t n_taps, int64_t factor, float* out, int64_t n_out) {
    const int64_t half = n_taps / 2;
    const int64_t A = (n_taps + factor - 1) / factor;  // taps per phase
    const int64_t M = n_out + A + 1;
    // phase b holds xz[factor*m + b] where xz is x shifted by the group
    // delay (zero outside [0, n)); then
    //   out[i] = sum_b sum_a taps[factor*a + b] * P_b[i + a]
    std::vector<float> phases(static_cast<size_t>(factor) * M, 0.0f);
    for (int64_t b = 0; b < factor; ++b) {
        float* P = phases.data() + b * M;
        const int64_t j0 = b - half;  // x index at m = 0
        int64_t m_lo = j0 < 0 ? (-j0 + factor - 1) / factor : 0;
        // last m with index < n; C++ division truncates toward zero, so a
        // negative numerator (possible when half < factor via the generic
        // ABI) must clamp to -1 explicitly or the fill loop reads past x
        int64_t m_hi = (n - 1 - j0) < 0 ? -1 : (n - 1 - j0) / factor;
        if (m_hi >= M) m_hi = M - 1;
        for (int64_t m = m_lo; m <= m_hi; ++m) P[m] = x[j0 + factor * m];
    }
    const int64_t BLK = 4096;  // out block stays L1-resident across taps
    for (int64_t s = 0; s < n_out; s += BLK) {
        const int64_t len = (n_out - s) < BLK ? (n_out - s) : BLK;
        float* o = out + s;
        for (int64_t i = 0; i < len; ++i) o[i] = 0.0f;
        for (int64_t b = 0; b < factor; ++b) {
            const float* P = phases.data() + b * M + s;
            for (int64_t a = 0; a < A; ++a) {
                const int64_t k = factor * a + b;
                if (k >= n_taps) break;
                const float t = taps[k];
                if (t == 0.0f) continue;
                const float* src = P + a;
                for (int64_t i = 0; i < len; ++i) o[i] += t * src[i];
            }
        }
    }
}

}  // extern "C"
