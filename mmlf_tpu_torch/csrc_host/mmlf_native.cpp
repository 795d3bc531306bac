// Host-side routines of mmlf_tpu_torch's data path, plain C interface.
//
// The port's copy of the JAX package's native/mmlf_native.cpp: the same
// arithmetic in the same order, so both libraries give equal masks and
// windows bit for bit.
//
//   * texture_mask — the 23×23 mean-absolute-deviation mask computed once
//     per scene when it is loaded; the accumulation over window offsets
//     runs over row bands in threads.
//
//   * strided_window — stride-f window extraction for the host training
//     pipeline: copies a (A, win, win, C) block out of an (A, H, W, C)
//     array with row-level inner loops; the ctypes call releases the GIL,
//     so a thread pool cuts many windows at once.
//
// Built by mmlf_tpu_torch/native.py with g++ at first use (-O3
// -march=native -ffp-contract=off, no -ffast-math: the sums keep their
// order and the norm stays one multiply).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

int hardware_threads() {
    unsigned n = std::thread::hardware_concurrency();
    return n ? static_cast<int>(n) : 4;
}

void parallel_rows(int n_rows, const std::function<void(int, int)>& fn) {
    int n_threads = std::min(hardware_threads(), n_rows);
    if (n_threads <= 1) {
        fn(0, n_rows);
        return;
    }
    std::vector<std::thread> threads;
    int chunk = (n_rows + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int lo = t * chunk;
        int hi = std::min(n_rows, lo + chunk);
        if (lo >= hi) break;
        threads.emplace_back(fn, lo, hi);
    }
    for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Mean-absolute-deviation texture mask.
//   center: (H, W, 3) float32, zero-padded window semantics
//   out:    (H, W) int32 — 1 where MAD >= threshold, with a wsize/2 margin
//           of zeros
void texture_mask(const float* center, int h, int w, int wsize,
                  float threshold, int32_t* out) {
    const int r = wsize / 2;
    const float norm = 1.0f / (static_cast<float>(wsize) * wsize * 3.0f);

    parallel_rows(h, [&](int y_lo, int y_hi) {
        for (int y = y_lo; y < y_hi; ++y) {
            for (int x = 0; x < w; ++x) {
                const float* c = center + (static_cast<int64_t>(y) * w + x) * 3;
                float acc = 0.0f;
                for (int dy = -r; dy <= r; ++dy) {
                    const int sy = y + dy;
                    const bool row_in = sy >= 0 && sy < h;
                    const float* row =
                        row_in ? center + static_cast<int64_t>(sy) * w * 3
                               : nullptr;
                    for (int dx = -r; dx <= r; ++dx) {
                        const int sx = x + dx;
                        if (row_in && sx >= 0 && sx < w) {
                            const float* p = row + static_cast<int64_t>(sx) * 3;
                            acc += std::fabs(p[0] - c[0]) +
                                   std::fabs(p[1] - c[1]) +
                                   std::fabs(p[2] - c[2]);
                        } else {
                            // zero padding contributes |0 - c|
                            acc += std::fabs(c[0]) + std::fabs(c[1]) +
                                   std::fabs(c[2]);
                        }
                    }
                }
                const float mad = acc * norm;
                const bool margin = y < r || y >= h - r || x < r || x >= w - r;
                out[static_cast<int64_t>(y) * w + x] =
                    (!margin && mad >= threshold) ? 1 : 0;
            }
        }
    });
}

// Stride-f window copy out of an (A, H, W, C) float32 array:
//   dst (A, win, win, C) <- src[a, (ws_y + i) * f, (ws_x + j) * f, :]
void strided_window(const float* src, int64_t a_dim, int64_t h, int64_t w,
                    int64_t c, int64_t ws_y, int64_t ws_x, int64_t f,
                    int64_t win, float* dst) {
    for (int64_t a = 0; a < a_dim; ++a) {
        const float* plane = src + a * h * w * c;
        float* dplane = dst + a * win * win * c;
        for (int64_t i = 0; i < win; ++i) {
            const float* row = plane + (ws_y + i) * f * w * c;
            float* drow = dplane + i * win * c;
            if (f == 1) {
                std::memcpy(drow, row + ws_x * c,
                            static_cast<size_t>(win * c) * sizeof(float));
            } else {
                for (int64_t j = 0; j < win; ++j) {
                    std::memcpy(drow + j * c, row + (ws_x + j) * f * c,
                                static_cast<size_t>(c) * sizeof(float));
                }
            }
        }
    }
}

}  // extern "C"
