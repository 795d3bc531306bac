// Fused double-conv trunk block (kernel K3), forward and backward, written
// for Hopper.
//
// Replaces the Pallas TPU kernel mmlf_tpu/ops/pallas/conv_block.py:
// fused_double_conv, forward _fwd / _fwd_kernel and backward
// _fused_bwd_rule / _bwd_kernel.  One trunk block, NCHW float32:
//
//   z   = [relu]([si * x + ti])          input stage (previous block's BN+ReLU)
//   y1  = relu(conv2x2_pad1(z) + b1)     (B, Cout, H+1, W+1), never saved
//   y2  = conv2x2_pad0(y1) + b2          (B, Cout, H, W)
//   ps  = sum y2, pss = sum y2^2         per channel over (B, H, W)
//
// The backward recomputes y1 from x (the residuals are x and y2 only) and
// gives dx, dsi, dti, dW1, db1, dW2, db2 from dy2, dps, dpss:
//
//   g2  = dy2 + dps + 2 y2 dpss,  db2 = sum g2
//   dy1 = [y1 > 0] dgrad2(g2),    db1 = sum dy1
//   dW2 = sum g2 (x) taps(y1),    dW1 = sum dy1 (x) taps(z)
//   dz  = dgrad1(dy1), masked by [si x + ti > 0] when relu_in;
//   dsi = sum dz x, dti = sum dz (affine_in), dx = dz si.
//
// Zero padding is in z, after the input stage: a tap outside the image reads
// 0, not relu(ti).  relu' at 0 is 0 on both relus.
//
// What bounds it on an H100 SXM: operations.  At the recipe's out_net shape
// (B 64, 96x96, 280 -> 280) the forward is 2 * 4 * 280^2 * (97^2 + 96^2) * 64
// = 0.75 TFLOP against 1.3 GB of x and y2: 11 ms at the 67 TFLOP/s fp32 peak
// of the CUDA cores, 0.4 ms of bytes.  The backward does five such GEMMs
// (y1 again, two dgrads, two wgrads): 28 ms.  The port is held to fp32 with
// TF32 off, so the products run as FFMA on the CUDA cores, not on the
// tensor cores.
//
// Design (simple and right first; not the fastest form):
//   * Layout: NCHW, the port's own.  The chain needs no conversion at the
//     stream entry or at the out_net exit, and the plain versions compare
//     as they are.  A pixel row is contiguous, so neighbouring threads take
//     neighbouring pixels.
//   * conv2x2_kernel: an implicit GEMM, out[n][m] = sum_k W[k][n] A[k][m]
//     over pixels m = (b, oy, ox) and k = ci*4 + tap (the OIHW order, so the
//     weight gradient comes out in the weights' own layout).  A block owns
//     128 pixels x TN output channels: TN = 96 with 8 x 8 sums per thread
//     (192 threads; 280 channels pad to 288, 70 to 96), 64 with 8 x 4 where
//     that pads less (108), 32 or 16 for narrow outputs (27, 2, 1).  A step
//     of the K loop is 4 input channels x 4 taps: each load slot takes the
//     2x2 neighbourhood of one pixel in one channel with predicated loads
//     (no branches; 32-bit offsets), applies the input stage and the zero
//     padding, and the next step's loads are in flight while the
//     shared-memory tiles of this step are used.  The epilogue adds the
//     bias and the ReLU, or masks by [y1 > 0] for dy1.
//   * Two launches per forward, with a transient y1 buffer: y1 is not kept
//     in shared memory across both convs (that fused form is a later
//     speed-up).  The saved residuals stay x and y2.
//   * Cross-block sums (ps, pss, db1, db2, dsi, dti): per-(channel, image)
//     partials from plane_kernel, then a fixed-order sum over the images.
//     The weight gradients: wgrad_kernel splits the pixel reduction into
//     chunks (not only over the batch) so that ~4 blocks per SM run, each
//     block writes its partial tile (96, 64 or 16 output channels x 128
//     GEMM columns, 8, 4 or 1 x 8 sums per thread, 16 pixels a step), and
//     sum_rows_kernel adds the chunks in order.  No atomics: every sum is
//     deterministic.
//   * dgrad of a k=2 conv is a k=2 conv with the kernel flipped in space and
//     in/out swapped, pad 1 <-> pad 0; the caller passes those weights.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TM = 128;        // output pixels per conv block
constexpr int BK = 16;         // GEMM depth per step: 4 input channels x 4 taps
constexpr int WK = 128;        // wgrad: GEMM columns (ci, tap) per block
constexpr int WS = 16;         // wgrad: pixels per step
constexpr int WGRAD_TARGET_BLOCKS = 4 * 132;

enum { IN_AFFINE = 1, IN_RELU = 2 };
enum { EPI_BIAS = 0, EPI_BIAS_RELU = 1, EPI_MASK = 2 };
enum { PLANE_STATS = 0, PLANE_G2 = 1, PLANE_SUM = 2, PLANE_IN_BWD = 3 };

__device__ __forceinline__ float in_stage(float v, float s, float t,
                                          int flags) {
  if (flags & IN_AFFINE) v = fmaf(v, s, t);
  if (flags & IN_RELU) v = fmaxf(v, 0.f);
  return v;
}

// One thread's 2x2 input neighbourhood of one pixel: its offset in x and
// which of the four taps lie inside the image.  Offsets are 32-bit: the
// host entry points refuse tensors of 2^31 elements or more.
struct Taps {
  int base;                    // offset of (b, 0, iy0, ix0) in x
  bool t0, t1, t2, t3;         // taps (0,0), (0,1), (1,0), (1,1) inside

  __device__ void at(int b, int oy, int ox, int cin, int hin, int win,
                     int pad, bool valid) {
    const int iy0 = oy - pad, ix0 = ox - pad;
    base = b * cin * hin * win + iy0 * win + ix0;
    const bool r0 = valid && iy0 >= 0 && iy0 < hin;
    const bool r1 = valid && iy0 + 1 >= 0 && iy0 + 1 < hin;
    const bool c0 = ix0 >= 0 && ix0 < win;
    const bool c1 = ix0 + 1 >= 0 && ix0 + 1 < win;
    t0 = r0 && c0;
    t1 = r0 && c1;
    t2 = r1 && c0;
    t3 = r1 && c1;
  }

  // The four taps of channel ci after the input stage, 0 outside the image
  // or past the last channel; predicated loads, no branches.
  __device__ void load(const float* __restrict__ x,
                       const float* __restrict__ si,
                       const float* __restrict__ ti, int flags, int ci,
                       int cin, int hw, int win, float v[4]) const {
    const bool ok = ci < cin;
    float s = 1.f, t = 0.f;
    if (flags & IN_AFFINE) {
      s = ok ? __ldg(si + ci) : 1.f;
      t = ok ? __ldg(ti + ci) : 0.f;
    }
    const int o = base + ci * hw;
    const bool p0 = ok && t0, p1 = ok && t1, p2 = ok && t2, p3 = ok && t3;
    const float a0 = p0 ? __ldg(x + o) : 0.f;
    const float a1 = p1 ? __ldg(x + o + 1) : 0.f;
    const float a2 = p2 ? __ldg(x + o + win) : 0.f;
    const float a3 = p3 ? __ldg(x + o + win + 1) : 0.f;
    v[0] = p0 ? in_stage(a0, s, t, flags) : 0.f;
    v[1] = p1 ? in_stage(a1, s, t, flags) : 0.f;
    v[2] = p2 ? in_stage(a2, s, t, flags) : 0.f;
    v[3] = p3 ? in_stage(a3, s, t, flags) : 0.f;
  }
};

// out (B, N, Ho, Wo) = conv2x2(in_stage(x), pad) with x (B, Cin, Hin, Win),
// Ho = Hin + 2 pad - 1; wt is the (4 Cin, N) GEMM weight, k = ci*4 + tap.
// A block owns TM pixels x TN output channels with 16 * TN / RN threads;
// each thread keeps 8 pixels x RN channels of sums.
template <int TN, int RN>
__global__ void __launch_bounds__(16 * TN / RN, 2)
conv2x2_kernel(const float* __restrict__ x, const float* __restrict__ si,
               const float* __restrict__ ti, int flags,
               const float* __restrict__ wt, const float* __restrict__ bias,
               const float* __restrict__ mask, float* __restrict__ out,
               int B, int cin, int hin, int win, int n_out, int pad,
               int epi) {
  constexpr int NT = 16 * TN / RN;
  constexpr int CH = BK / 4;                        // input channels a step
  constexpr int A_SLOTS = (TM * CH + NT - 1) / NT;  // (pixel, channel) loads
  constexpr int W_ROWS = NT / TN;                   // weight rows a pass
  constexpr int W_PER = BK / W_ROWS;
  static_assert(NT % TN == 0 && BK % W_ROWS == 0, "weight tile split");
  __shared__ __align__(16) float As[2][BK][TM];
  __shared__ __align__(16) float Ws[2][BK][TN];

  const int tid = threadIdx.x;
  const int ho = hin + 2 * pad - 1, wo = win + 2 * pad - 1;
  const int hwo = ho * wo;
  const long long M = (long long)B * hwo;
  const int K = 4 * cin;
  const long long m0 = (long long)blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;

  // load slots: slot s = tid + i*NT is pixel s % TM of channel s / TM of
  // the step; each loads that pixel's 2x2 neighbourhood
  Taps taps[A_SLOTS];
  int slot_m[A_SLOTS], slot_c[A_SLOTS];
#pragma unroll
  for (int i = 0; i < A_SLOTS; ++i) {
    const int sl = tid + i * NT;
    slot_m[i] = sl % TM;
    slot_c[i] = sl < TM * CH ? sl / TM : CH;       // CH: no slot
    const long long m = m0 + slot_m[i];
    const bool valid = m < M && slot_c[i] < CH;
    int b = 0, oy = 0, ox = 0;
    if (valid) {
      b = (int)(m / hwo);
      const int r = (int)(m - (long long)b * hwo);
      oy = r / wo;
      ox = r - oy * wo;
    }
    taps[i].at(b, oy, ox, cin, hin, win, pad, valid);
  }

  // weight load slots: column n_w of the tile, rows kk_w + i * W_ROWS
  const int n_w = tid % TN, kk_w = tid / TN;
  const bool ok_w = n0 + n_w < n_out;
  const int hw = hin * win;

  float a_reg[A_SLOTS][4];
  float w_reg[W_PER];
  auto load = [&](int kt) {
#pragma unroll
    for (int i = 0; i < A_SLOTS; ++i)
      taps[i].load(x, si, ti, flags, kt * CH + slot_c[i], cin, hw, win,
                   a_reg[i]);
    const int k = kt * BK + kk_w;
    const float* wp = wt + k * n_out + n0 + n_w;
#pragma unroll
    for (int i = 0; i < W_PER; ++i)
      w_reg[i] = (ok_w && k + i * W_ROWS < K)
                     ? __ldg(wp + i * W_ROWS * n_out) : 0.f;
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_SLOTS; ++i)
      if (slot_c[i] < CH)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          As[buf][slot_c[i] * 4 + j][slot_m[i]] = a_reg[i][j];
#pragma unroll
    for (int i = 0; i < W_PER; ++i) Ws[buf][kk_w + i * W_ROWS][n_w] = w_reg[i];
  };

  // compute slot: pixels tm*4 + {0..3} and 64 + tm*4 + {0..3} (conflict-free
  // float4 reads), channels tn*RN + {0..RN-1}
  const int tm = tid & 15, tn = tid >> 4;
  float acc[8][RN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  const int KT = (cin + CH - 1) / CH;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < KT) load(kt + 1);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][tm * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][kk][64 + tm * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float w[RN];
      if constexpr (RN % 4 == 0) {
#pragma unroll
        for (int q = 0; q < RN / 4; ++q) {
          const float4 v =
              *reinterpret_cast<const float4*>(&Ws[buf][kk][tn * RN + 4 * q]);
          w[4 * q] = v.x; w[4 * q + 1] = v.y;
          w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
        }
      } else if constexpr (RN == 2) {
        const float2 v = *reinterpret_cast<const float2*>(&Ws[buf][kk][tn * 2]);
        w[0] = v.x; w[1] = v.y;
      } else {
        w[0] = Ws[buf][kk][tn];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    if (kt + 1 < KT) store(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + (i < 4 ? tm * 4 + i : 64 + tm * 4 + (i - 4));
    if (m >= M) continue;
    const int b = (int)(m / hwo);
    const int r = (int)(m - (long long)b * hwo);
    const long long obase = (long long)b * n_out * hwo + r;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int n = n0 + tn * RN + j;
      if (n >= n_out) continue;
      const long long o = obase + (long long)n * hwo;
      float v = acc[i][j];
      if (epi == EPI_MASK) {
        v = __ldg(mask + o) > 0.f ? v : 0.f;
      } else {
        if (bias != nullptr) v += __ldg(bias + n);
        if (epi == EPI_BIAS_RELU) v = fmaxf(v, 0.f);
      }
      out[o] = v;
    }
  }
}

// Sum of one value per thread over the block, in a fixed order; the result
// is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();             // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  return s;
}

// One block per (channel c, image b) plane of hw pixels; writes the
// per-plane partial sums part[0][b][c] (and part[1][b][c]).
//   PLANE_STATS:  sum t, sum t^2                       (t = y2)
//   PLANE_G2:     g = t + dps + 2 u dpss -> out; sum g (t = dy2, u = y2)
//   PLANE_SUM:    sum t                                (t = dy1)
//   PLANE_IN_BWD: out holds dz; dz *= [pre > 0]; sums dz x and dz; out = dz si
//                 (t = x)
template <int MODE>
__global__ void __launch_bounds__(THREADS)
plane_kernel(const float* __restrict__ t, const float* __restrict__ u,
             const float* __restrict__ pa, const float* __restrict__ pb,
             int flags, float* __restrict__ out, float* __restrict__ part,
             int B, int C, int hw) {
  __shared__ float red[THREADS / 32];
  const int c = blockIdx.x, b = blockIdx.y;
  const long long base = ((long long)b * C + c) * hw;
  float s1 = 0.f, s2 = 0.f;
  float a = 0.f, d = 0.f;
  if (MODE == PLANE_G2) {
    a = __ldg(pa + c);
    d = 2.f * __ldg(pb + c);
  }
  if (MODE == PLANE_IN_BWD) {
    a = (flags & IN_AFFINE) ? __ldg(pa + c) : 1.f;
    d = (flags & IN_AFFINE) ? __ldg(pb + c) : 0.f;
  }
  for (int i = threadIdx.x; i < hw; i += THREADS) {
    const long long o = base + i;
    const float v = __ldg(t + o);
    if (MODE == PLANE_STATS) {
      s1 += v;
      s2 = fmaf(v, v, s2);
    } else if (MODE == PLANE_G2) {
      const float g = v + a + d * __ldg(u + o);
      out[o] = g;
      s1 += g;
    } else if (MODE == PLANE_SUM) {
      s1 += v;
    } else {
      float dz = out[o];
      if ((flags & IN_RELU) && !(in_stage(v, a, d, flags & IN_AFFINE) > 0.f))
        dz = 0.f;
      s1 = fmaf(dz, v, s1);
      s2 += dz;
      out[o] = (flags & IN_AFFINE) ? dz * a : dz;
    }
  }
  const float r1 = block_sum(s1, red);
  if (threadIdx.x == 0) part[(long long)b * C + c] = r1;
  if (MODE == PLANE_STATS || MODE == PLANE_IN_BWD) {
    const float r2 = block_sum(s2, red);
    if (threadIdx.x == 0) part[(long long)B * C + (long long)b * C + c] = r2;
  }
}

// out[j] = sum_{s < S} part[s * L + j], s in order.
__global__ void __launch_bounds__(THREADS)
sum_rows_kernel(const float* __restrict__ part, int S, long long L,
                float* __restrict__ out) {
  const long long j = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (j >= L) return;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += __ldg(part + (long long)k * L + j);
  out[j] = s;
}

// Weight gradient of one conv2x2: part[chunk][n][k] = sum over the chunk's
// pixels m of g[b, n, oy, ox] * A[k][m], A the implicit im2col of
// in_stage(x) with the conv's pad (as in conv2x2_kernel).  A block owns WN
// output channels x WK GEMM columns with 16 * WN / RN threads; each thread
// keeps RN channels x 8 columns of sums.
template <int WN, int RN>
__global__ void __launch_bounds__(16 * WN / RN, 2)
wgrad_kernel(const float* __restrict__ g, const float* __restrict__ x,
             const float* __restrict__ si, const float* __restrict__ ti,
             int flags, float* __restrict__ part, int B, int cin, int hin,
             int win, int n_out, int pad, long long chunk_len) {
  constexpr int NT = 16 * WN / RN;
  constexpr int ROWS = WN / RN;                     // thread rows
  constexpr int A_SLOTS = (WK / 4 + ROWS - 1) / ROWS;
  __shared__ __align__(16) float Gs[2][WS][WN + 4];
  __shared__ __align__(16) float As[2][WS][WK + 4];

  const int tid = threadIdx.x;
  const int ho = hin + 2 * pad - 1, wo = win + 2 * pad - 1;
  const int hwo = ho * wo;
  const long long M = (long long)B * hwo;
  const int K = 4 * cin;
  const int k0 = blockIdx.x * WK, n0 = blockIdx.y * WN;
  const long long m_begin = (long long)blockIdx.z * chunk_len;
  const long long m_end = m_begin + chunk_len < M ? m_begin + chunk_len : M;

  // load slot: pixel lane lp of each step; G rows rg + ROWS j (j < RN), A
  // channels rg + ROWS i (i < A_SLOTS, below WK / 4) with their 4 taps
  const int lp = tid & 15, rg = tid >> 4;
  long long m = m_begin + lp;
  int b = 0, oy = 0, ox = 0;
  if (m < M) {
    b = (int)(m / hwo);
    const int r = (int)(m - (long long)b * hwo);
    oy = r / wo;
    ox = r - oy * wo;
  }

  float g_reg[RN], a_reg[A_SLOTS][4];
  auto load = [&]() {
    const bool valid = m < m_end;
    const long long gbase = (long long)b * n_out * hwo + (long long)oy * wo + ox;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int n = n0 + rg + ROWS * j;
      g_reg[j] = (valid && n < n_out)
                     ? __ldg(g + gbase + (long long)n * hwo) : 0.f;
    }
    Taps taps;
    taps.at(b, oy, ox, cin, hin, win, pad, valid);
#pragma unroll
    for (int i = 0; i < A_SLOTS; ++i) {
      const int c = rg + ROWS * i;
      if (c < WK / 4)
        taps.load(x, si, ti, flags, k0 / 4 + c, cin, hin * win, win,
                  a_reg[i]);
    }
    // advance this thread's pixel by one step
    m += WS;
    ox += WS;
    while (ox >= wo) {
      ox -= wo;
      if (++oy == ho) {
        oy = 0;
        ++b;
      }
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < RN; ++j) Gs[buf][lp][rg + ROWS * j] = g_reg[j];
#pragma unroll
    for (int i = 0; i < A_SLOTS; ++i) {
      const int c = rg + ROWS * i;
      if (c < WK / 4)
#pragma unroll
        for (int t = 0; t < 4; ++t) As[buf][lp][c * 4 + t] = a_reg[i][t];
    }
  };

  // compute slot: channels ty*RN + {0..RN-1}, columns tx*4 + {0..3} and
  // 64 + tx*4 + {0..3}
  const int tx = tid & 15, ty = tid >> 4;
  float acc[RN][8];
#pragma unroll
  for (int i = 0; i < RN; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const long long steps = (m_end - m_begin + WS - 1) / WS;
  if (steps > 0) {
    load();
    store(0);
  }
  __syncthreads();
  for (long long s = 0; s < steps; ++s) {
    const int buf = (int)(s & 1);
    if (s + 1 < steps) load();
#pragma unroll
    for (int p = 0; p < WS; ++p) {
      float gg[RN];
      if constexpr (RN % 4 == 0) {
#pragma unroll
        for (int q = 0; q < RN / 4; ++q) {
          const float4 v =
              *reinterpret_cast<const float4*>(&Gs[buf][p][ty * RN + 4 * q]);
          gg[4 * q] = v.x; gg[4 * q + 1] = v.y;
          gg[4 * q + 2] = v.z; gg[4 * q + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < RN; ++q) gg[q] = Gs[buf][p][ty * RN + q];
      }
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][p][tx * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][p][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < RN; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(gg[i], a[j], acc[i][j]);
    }
    if (s + 1 < steps) store(buf ^ 1);
    __syncthreads();
  }

  const long long L = (long long)n_out * K;
  float* dst = part + (long long)blockIdx.z * L;
#pragma unroll
  for (int i = 0; i < RN; ++i) {
    const int n = n0 + ty * RN + i;
    if (n >= n_out) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (k < K) dst[(long long)n * K + k] = acc[i][j];
    }
  }
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// Output channels per block: 96 (8 a thread) or 64 (4 a thread), whichever
// pads n_out less, and narrower tiles for narrow outputs.
int channel_tile(int n_out, bool narrow) {
  if (n_out <= 16) return 16;
  if (narrow && n_out <= 32) return 32;
  return ceil_div(n_out, 96) * 96 <= ceil_div(n_out, 64) * 64 ? 96 : 64;
}

template <int TN, int RN>
void launch_conv(const float* x, const float* si, const float* ti, int flags,
                 const float* wt, const float* bias, const float* mask,
                 float* out, int B, int cin, int hin, int win, int n_out,
                 int pad, int epi, unsigned gx, cudaStream_t st) {
  conv2x2_kernel<TN, RN><<<dim3(gx, ceil_div(n_out, TN)), 16 * TN / RN, 0,
                           st>>>(x, si, ti, flags, wt, bias, mask, out, B,
                                 cin, hin, win, n_out, pad, epi);
}

cudaError_t conv2x2(const float* x, const float* si, const float* ti,
                    int flags, const float* wt, const float* bias,
                    const float* mask, float* out, int B, int cin, int hin,
                    int win, int n_out, int pad, int epi, cudaStream_t st) {
  const long long M = (long long)B * (hin + 2 * pad - 1) * (win + 2 * pad - 1);
  const unsigned gx = (unsigned)ceil_div(M, TM);
  switch (channel_tile(n_out, true)) {
    case 16:
      launch_conv<16, 1>(x, si, ti, flags, wt, bias, mask, out, B, cin, hin,
                         win, n_out, pad, epi, gx, st);
      break;
    case 32:
      launch_conv<32, 2>(x, si, ti, flags, wt, bias, mask, out, B, cin, hin,
                         win, n_out, pad, epi, gx, st);
      break;
    case 64:
      launch_conv<64, 4>(x, si, ti, flags, wt, bias, mask, out, B, cin, hin,
                         win, n_out, pad, epi, gx, st);
      break;
    default:
      launch_conv<96, 8>(x, si, ti, flags, wt, bias, mask, out, B, cin, hin,
                         win, n_out, pad, epi, gx, st);
  }
  return cudaGetLastError();
}

// Pixel chunking of one weight gradient: enough blocks to fill the card,
// chunks a multiple of WS pixels long.
struct Chunks {
  long long len;
  int count;
};

Chunks wgrad_chunks(int B, int cin, int hin, int win, int n_out, int pad) {
  const long long M = (long long)B * (hin + 2 * pad - 1) * (win + 2 * pad - 1);
  const int wn = channel_tile(n_out, false);
  const int tiles = ceil_div(n_out, wn) * ceil_div(4 * cin, WK);
  long long want = ceil_div(WGRAD_TARGET_BLOCKS, tiles);
  const long long most = ceil_div(M, 16 * WS);
  if (want > most) want = most;
  if (want < 1) want = 1;
  Chunks c;
  c.len = (long long)ceil_div(ceil_div(M, want), WS) * WS;
  c.count = ceil_div(M, c.len);
  return c;
}

template <int WN, int RN>
void launch_wgrad(const float* g, const float* x, const float* si,
                  const float* ti, int flags, float* part, int B, int cin,
                  int hin, int win, int n_out, int pad, Chunks ch,
                  cudaStream_t st) {
  const dim3 grid(ceil_div(4 * cin, WK), ceil_div(n_out, WN), ch.count);
  wgrad_kernel<WN, RN><<<grid, 16 * WN / RN, 0, st>>>(
      g, x, si, ti, flags, part, B, cin, hin, win, n_out, pad, ch.len);
}

cudaError_t wgrad(const float* g, const float* x, const float* si,
                  const float* ti, int flags, float* part, float* dw, int B,
                  int cin, int hin, int win, int n_out, int pad,
                  cudaStream_t st) {
  const Chunks ch = wgrad_chunks(B, cin, hin, win, n_out, pad);
  switch (channel_tile(n_out, false)) {
    case 16:
      launch_wgrad<16, 1>(g, x, si, ti, flags, part, B, cin, hin, win, n_out,
                          pad, ch, st);
      break;
    case 64:
      launch_wgrad<64, 4>(g, x, si, ti, flags, part, B, cin, hin, win, n_out,
                          pad, ch, st);
      break;
    default:
      launch_wgrad<96, 8>(g, x, si, ti, flags, part, B, cin, hin, win, n_out,
                          pad, ch, st);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long L = (long long)n_out * 4 * cin;
  sum_rows_kernel<<<ceil_div(L, THREADS), THREADS, 0, st>>>(part, ch.count, L,
                                                            dw);
  return cudaGetLastError();
}

cudaError_t sum_images(const float* part, int B, int C, float* out,
                       cudaStream_t st) {
  sum_rows_kernel<<<ceil_div(C, THREADS), THREADS, 0, st>>>(part, B, C, out);
  return cudaGetLastError();
}

bool bad_shape(int B, int cin, int H, int W, int cout) {
  return B < 1 || B > 65535 || cin < 1 || cout < 1 || H < 1 || W < 1 ||
         (long long)B * (cin > cout ? cin : cout) * (H + 1) * (W + 1) >=
             (1LL << 31);
}

long long wgrad_scratch(int B, int cin, int H, int W, int cout) {
  const Chunks c2 = wgrad_chunks(B, cout, H + 1, W + 1, cout, 0);
  const Chunks c1 = wgrad_chunks(B, cin, H, W, cout, 1);
  const long long s2 = (long long)c2.count * cout * 4 * cout;
  const long long s1 = (long long)c1.count * cout * 4 * cin;
  return s1 > s2 ? s1 : s2;
}

}  // namespace

#define MMLF_TRY(call)                       \
  do {                                       \
    const cudaError_t e_ = (call);           \
    if (e_ != cudaSuccess) return (int)e_;   \
  } while (0)

extern "C" {

// Floats of the wgrad scratch that mmlf_conv_block_bwd needs.
long long mmlf_conv_block_wgrad_scratch(int B, int cin, int H, int W,
                                        int cout) {
  return wgrad_scratch(B, cin, H, W, cout);
}

// Forward.  x (B, Cin, H, W); si, ti (Cin) (read only with affine_in); w1t
// (4 Cin, Cout) and w2t (4 Cout, Cout) GEMM weights (OIHW flattened and
// transposed); b1, b2 (Cout).  Writes y1 (B, Cout, H+1, W+1, scratch), y2
// (B, Cout, H, W), part (2 B Cout, scratch), ps and pss (Cout).
int mmlf_conv_block_fwd(const float* x, const float* si, const float* ti,
                        const float* w1t, const float* b1, const float* w2t,
                        const float* b2, float* y1, float* y2, float* part,
                        float* ps, float* pss, int B, int cin, int H, int W,
                        int cout, int relu_in, int affine_in, int device,
                        void* stream) {
  if (bad_shape(B, cin, H, W, cout)) return (int)cudaErrorInvalidValue;
  MMLF_TRY(cudaSetDevice(device));
  const cudaStream_t st = (cudaStream_t)stream;
  const int flags = (affine_in ? IN_AFFINE : 0) | (relu_in ? IN_RELU : 0);
  MMLF_TRY(conv2x2(x, si, ti, flags, w1t, b1, nullptr, y1, B, cin, H, W,
                   cout, 1, EPI_BIAS_RELU, st));
  MMLF_TRY(conv2x2(y1, nullptr, nullptr, 0, w2t, b2, nullptr, y2, B, cout,
                   H + 1, W + 1, cout, 0, EPI_BIAS, st));
  plane_kernel<PLANE_STATS><<<dim3(cout, B), THREADS, 0, st>>>(
      y2, nullptr, nullptr, nullptr, 0, nullptr, part, B, cout, H * W);
  MMLF_TRY(cudaGetLastError());
  MMLF_TRY(sum_images(part, B, cout, ps, st));
  MMLF_TRY(sum_images(part + (long long)B * cout, B, cout, pss, st));
  return (int)cudaSuccess;
}

// Backward.  Inputs as the forward's, plus w1dgt (4 Cout, Cin) and w2dgt
// (4 Cout, Cout), the GEMM weights of the two dgrad convs (kernels flipped
// in space, in/out swapped); y2, dy2 (B, Cout, H, W); dps, dpss (Cout).
// Scratch: y1 and dy1 (B, Cout, H+1, W+1), g2 (B, Cout, H, W), wpart
// (mmlf_conv_block_wgrad_scratch floats), bpart (2 B max(Cin, Cout)).
// Writes dx (B, Cin, H, W), dw1 (Cout, 4 Cin), dw2 (Cout, 4 Cout), db1, db2
// (Cout), dsi, dti (Cin; zeros without affine_in).
int mmlf_conv_block_bwd(const float* x, const float* si, const float* ti,
                        const float* w1t, const float* b1,
                        const float* w1dgt, const float* w2dgt,
                        const float* y2, const float* dy2, const float* dps,
                        const float* dpss, float* y1, float* g2, float* dy1,
                        float* wpart, float* bpart, float* dx, float* dw1,
                        float* db1, float* dw2, float* db2, float* dsi,
                        float* dti, int B, int cin, int H, int W, int cout,
                        int relu_in, int affine_in, int device,
                        void* stream) {
  if (bad_shape(B, cin, H, W, cout)) return (int)cudaErrorInvalidValue;
  MMLF_TRY(cudaSetDevice(device));
  const cudaStream_t st = (cudaStream_t)stream;
  const int flags = (affine_in ? IN_AFFINE : 0) | (relu_in ? IN_RELU : 0);
  const int H1 = H + 1, W1 = W + 1;

  // y1 again, from the x residual
  MMLF_TRY(conv2x2(x, si, ti, flags, w1t, b1, nullptr, y1, B, cin, H, W,
                   cout, 1, EPI_BIAS_RELU, st));
  // g2 and db2
  plane_kernel<PLANE_G2><<<dim3(cout, B), THREADS, 0, st>>>(
      dy2, y2, dps, dpss, 0, g2, bpart, B, cout, H * W);
  MMLF_TRY(cudaGetLastError());
  MMLF_TRY(sum_images(bpart, B, cout, db2, st));
  // dy1 = [y1 > 0] dgrad2(g2) and db1
  MMLF_TRY(conv2x2(g2, nullptr, nullptr, 0, w2dgt, nullptr, y1, dy1, B, cout,
                   H, W, cout, 1, EPI_MASK, st));
  plane_kernel<PLANE_SUM><<<dim3(cout, B), THREADS, 0, st>>>(
      dy1, nullptr, nullptr, nullptr, 0, nullptr, bpart, B, cout, H1 * W1);
  MMLF_TRY(cudaGetLastError());
  MMLF_TRY(sum_images(bpart, B, cout, db1, st));
  // dz = dgrad1(dy1) into dx, then the input stage's backward in place
  MMLF_TRY(conv2x2(dy1, nullptr, nullptr, 0, w1dgt, nullptr, nullptr, dx, B,
                   cout, H1, W1, cin, 0, EPI_BIAS, st));
  if (flags) {
    plane_kernel<PLANE_IN_BWD><<<dim3(cin, B), THREADS, 0, st>>>(
        x, nullptr, si, ti, flags, dx, bpart, B, cin, H * W);
    MMLF_TRY(cudaGetLastError());
  }
  if (affine_in) {
    MMLF_TRY(sum_images(bpart, B, cin, dsi, st));
    MMLF_TRY(sum_images(bpart + (long long)B * cin, B, cin, dti, st));
  } else {
    MMLF_TRY(cudaMemsetAsync(dsi, 0, sizeof(float) * cin, st));
    MMLF_TRY(cudaMemsetAsync(dti, 0, sizeof(float) * cin, st));
  }
  // weight gradients: dW2 = sum g2 (x) taps(y1), dW1 = sum dy1 (x) taps(z)
  MMLF_TRY(wgrad(g2, y1, nullptr, nullptr, 0, wpart, dw2, B, cout, H1, W1,
                 cout, 0, st));
  MMLF_TRY(wgrad(dy1, x, si, ti, flags, wpart, dw1, B, cin, H, W, cout, 1,
                 st));
  return (int)cudaSuccess;
}

const char* mmlf_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
