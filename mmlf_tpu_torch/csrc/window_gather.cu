// Training-window gather from the packed scene pyramid, written for Hopper.
//
// Replaces the Pallas TPU kernel mmlf_tpu/ops/pallas/window_gather.py
// (_gather_kernel / pallas_window_gather).  For every sample b it copies
// one win x win window of scene s[b] at pyramid level lev[b], starting at
// row wy[b] and column wx[b], from three packed fields:
//
//   img  (S, Hf, Wf, CI)        -> out_img (B, win, win, CI)  fp32 or bf16
//   aux  (S, Hf, Wf * 8)        -> out_aux (B, win, win * 8)
//   mpi  (S, Hf, Wf * 64)       -> out_mpi (B, win, win * 64)   (optional)
//
// It is a pure copy and reads only the selected level.  The packed layout
// and the padded channel counts are kept, so the output is bit-identical
// to the TPU kernel's.  The image field is float32, or bfloat16 under
// --cache_bf16 (the TPU kernel returns it in the cache's dtype); aux and
// mpi are always float32.  The kernel moves 16-byte words and only the
// image row's word count depends on the element size.
//
// What bounds it on an H100 SXM: bytes.  Each window row of a field is
// one contiguous run in both the source and the output (64 KiB of img,
// 4 KiB of aux and 32 KiB of mpi at win = 128, CI = 128), so the work is
// B * win * win * (CI * e + (8 [+ 64]) * 4) bytes read and the same
// written, e the image element's bytes: 1.14 GB at B = 64 without the MPI
// field, ~0.34 ms at 3.35 TB/s, and 0.60 GB, ~0.18 ms, with a bf16 image
// field.  The
// design keeps every access a 16-byte vector on consecutive addresses:
//   * one block per (window row, sample); it reads the sample's scene,
//     level and offsets once and picks the level's base pointers from a
//     table passed by value (up to MAX_LEVELS levels);
//   * the block's threads walk the three row runs with float4 loads and
//     stores, neighbouring threads on neighbouring 16-byte words;
//   * without the MPI field the block skips it, so those bytes are never
//     read.
// TMA bulk copies and persistent blocks are left to a later version.
//
// Window copies (the probe scripts' kernels).  The same file also holds the
// one-field, one-level form of that copy, the counterpart of the probe
// scripts' Pallas kernels scripts/gather_probe3.py and gather_probe4.py
// (pallas_gather) and gather_probe4.py (pallas_gather2):
//
//   out (B, win, win, C) = cache[s[b], wy[b]:wy[b]+win, wx[b]:wx[b]+win, :]
//
// from a (S, H, W, C) cache, HBM to HBM.  Bound on an H100 SXM: bytes,
// B * win^2 * C * e read and the same written (0.199 GB at probe3's shape,
// 0.059 ms at 3.35 TB/s; 1.074 GB, 0.321 ms, at probe4's).
//   * window_copy_kernel (pallas_gather): one block per (window row,
//     sample), the row's run copied by the block's threads in words of 16
//     bytes when a pixel is a whole number of them, else in 4-byte words:
//     probe3's 27-channel pixel is 108 bytes and its columns start
//     anywhere, so its runs start at 4-byte alignment.
//   * window_copy_ring_kernel (pallas_gather2, whose DMA for window b + 1
//     starts while it waits on window b): persistent blocks, one an SM,
//     each walking its pieces of window rows (a row, or a RING_SLOT slice
//     of one) through a two-slot shared-memory ring.  One thread issues
//     everything: the cp.async.bulk load of the next piece into the free
//     slot (completing on that slot's mbarrier) while the bulk store of the
//     current piece drains the other.  Bulk copies need 16-byte aligned
//     addresses and sizes, so this schedule takes 16-byte pixels only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int THREADS = 256;
constexpr int AUX_CH = 8;
constexpr int MPI_CH = 64;

struct Levels {
  const float4* img[MAX_LEVELS];
  const float4* aux[MAX_LEVELS];
  const float4* mpi[MAX_LEVELS];
  int height[MAX_LEVELS];
  int width[MAX_LEVELS];
};

__device__ __forceinline__ void copy_run(const float4* __restrict__ src,
                                         float4* __restrict__ dst, int n) {
  for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = __ldg(src + i);
}

__global__ void __launch_bounds__(THREADS)
window_gather_kernel(Levels lv, const int* __restrict__ idx, int n_batch,
                     int win, int img4, int with_mpi,
                     float4* __restrict__ out_img,
                     float4* __restrict__ out_aux,
                     float4* __restrict__ out_mpi) {
  const int r = blockIdx.x;            // window row
  const int b = blockIdx.y;            // sample
  const int s = idx[b];
  const int lev = idx[n_batch + b];
  const int wy = idx[2 * n_batch + b];
  const int wx = idx[3 * n_batch + b];
  const long long row = (long long)s * lv.height[lev] + wy + r;
  const long long pix = row * lv.width[lev] + wx;   // first source pixel
  const long long out_row = (long long)b * win + r;

  copy_run(lv.img[lev] + pix * img4, out_img + out_row * win * img4,
           win * img4);
  constexpr int aux4 = AUX_CH / 4;
  copy_run(lv.aux[lev] + pix * aux4, out_aux + out_row * win * aux4,
           win * aux4);
  if (with_mpi) {
    constexpr int mpi4 = MPI_CH / 4;
    copy_run(lv.mpi[lev] + pix * mpi4, out_mpi + out_row * win * mpi4,
             win * mpi4);
  }
}

// ---------------------------------------------------------------- window copies

constexpr int RING_SLOT = 64 * 1024;     // bytes of one slot of the ring
constexpr int RING_THREADS = 32;

// Run of `n` words from src to dst, the block's threads on consecutive words.
template <class Word>
__device__ __forceinline__ void copy_words(const Word* __restrict__ src,
                                           Word* __restrict__ dst,
                                           long long n) {
  for (long long i = threadIdx.x; i < n; i += THREADS) dst[i] = __ldg(src + i);
}

// One block per (window row r, sample b): row wy + r of scene s from column
// wx on, row_words words, into row (b, r) of out.  px_words: words a pixel.
template <class Word>
__global__ void __launch_bounds__(THREADS)
window_copy_kernel(const Word* __restrict__ src, const int* __restrict__ idx,
                   int n_batch, int height, int width, int win, int px_words,
                   Word* __restrict__ out) {
  const int r = blockIdx.x, b = blockIdx.y;
  const long long s = idx[b], wy = idx[n_batch + b], wx = idx[2 * n_batch + b];
  const long long pix = (s * height + wy + r) * width + wx;
  const long long row_words = (long long)win * px_words;
  copy_words(src + pix * px_words, out + ((long long)b * win + r) * row_words,
             row_words);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// this thread's arrival, announcing `bytes` of copies to come
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// global -> shared, bytes a multiple of 16, both 16-byte aligned; completes
// on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// shared -> global in the bulk group of this thread
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// every committed bulk store has read its shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// every committed bulk store is complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Persistent blocks over units u = (b, r, piece): row r of window b cut into
// `pieces` slices of piece_bytes (the last one shorter).  Unit k of a block
// goes through slot k % 2: its load is issued while unit k - 1 is stored.
__global__ void __launch_bounds__(RING_THREADS)
window_copy_ring_kernel(const unsigned char* __restrict__ src,
                        const int* __restrict__ idx, int n_batch, int height,
                        int width, int win, int px_bytes, int pieces,
                        int piece_bytes, unsigned char* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = (uint64_t*)(smem + 2 * RING_SLOT);
  if (threadIdx.x != 0) return;
  mbar_init(bar, 1);
  mbar_init(bar + 1, 1);
  fence_mbar_init();
  const long long row_bytes = (long long)win * px_bytes;
  const long long units = (long long)n_batch * win * pieces;
  // source and destination address and size of unit u
  auto unit = [&](long long u, const unsigned char** from,
                  unsigned char** to) {
    const int p = (int)(u % pieces);
    const long long row = u / pieces;           // b * win + r
    const int b = (int)(row / win), r = (int)(row % win);
    const long long s = idx[b], wy = idx[n_batch + b], wx = idx[2 * n_batch + b];
    const long long off = (long long)p * piece_bytes;
    *from = src + ((s * height + wy + r) * width + wx) * px_bytes + off;
    *to = out + row * row_bytes + off;
    const long long left = row_bytes - off;
    return (int)(left < piece_bytes ? left : piece_bytes);
  };
  const unsigned char* from;
  unsigned char* to;
  long long u = blockIdx.x;
  if (u < units) {
    const int n = unit(u, &from, &to);
    mbar_arrive_expect(bar, n);
    bulk_load(smem, from, n, bar);
  }
  for (int k = 0; u < units; u += gridDim.x, ++k) {
    const int slot = k & 1;
    const long long next = u + gridDim.x;
    if (next < units) {
      bulk_wait_read();                // the other slot's store has read it
      const int n = unit(next, &from, &to);
      mbar_arrive_expect(bar + (slot ^ 1), n);
      bulk_load(smem + (slot ^ 1) * RING_SLOT, from, n, bar + (slot ^ 1));
    }
    mbar_wait(bar + slot, (k >> 1) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const int n = unit(u, &from, &to);
    bulk_store(to, smem + slot * RING_SLOT, n);
  }
  bulk_wait();
}

}  // namespace

extern "C" {

int mmlf_window_gather_max_levels() { return MAX_LEVELS; }

// img / aux / mpi: host arrays of n_levels device pointers (mpi may hold
// nulls when with_mpi is 0); heights / widths: host arrays of the levels'
// Hf and Wf; idx: device int32 (4, n_batch) = scene, level, wy, wx;
// img_bytes: 4 (float32) or 2 (bfloat16) bytes an image element.  The
// caller validates the indices against the level shapes.
int mmlf_window_gather_launch(const void* const* img, const void* const* aux,
                              const void* const* mpi, const int* heights,
                              const int* widths, int n_levels,
                              const void* idx, int n_batch, int win, int ci,
                              int img_bytes, int with_mpi, void* out_img,
                              void* out_aux,
                              void* out_mpi, int device, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || n_batch < 1 ||
      n_batch > 65535 || win < 1 || ci < 1 ||
      (img_bytes != 2 && img_bytes != 4) || (ci * img_bytes) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Levels lv;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    const bool used = l < n_levels;
    lv.img[l] = used ? (const float4*)img[l] : nullptr;
    lv.aux[l] = used ? (const float4*)aux[l] : nullptr;
    lv.mpi[l] = used && with_mpi ? (const float4*)mpi[l] : nullptr;
    lv.height[l] = used ? heights[l] : 0;
    lv.width[l] = used ? widths[l] : 0;
  }
  const dim3 grid((unsigned)win, (unsigned)n_batch);
  window_gather_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      lv, (const int*)idx, n_batch, win, ci * img_bytes / 16, with_mpi,
      (float4*)out_img, (float4*)out_aux, (float4*)out_mpi);
  return (int)cudaGetLastError();
}

// Window copy (one field, one level).  cache (S, H, W, C) of px_bytes
// bytes a pixel (a multiple of 4); idx: device int32 (3, n_batch) = scene,
// wy, wx, validated by the caller; out (n_batch, win, win, C).  ring 0:
// window_copy_kernel, in 16-byte words when px_bytes and both pointers allow
// it, else 4-byte words; ring 1: window_copy_ring_kernel (px_bytes a
// multiple of 16 and both pointers 16-byte aligned, else an error).
int mmlf_window_copy_launch(const void* cache, const void* idx, int n_batch,
                            int height, int width, int win, int px_bytes,
                            int ring, void* out, int device, void* stream) {
  if (n_batch < 1 || n_batch > 65535 || win < 1 || height < win ||
      width < win || px_bytes < 4 || px_bytes % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const bool wide = px_bytes % 16 == 0 && (uintptr_t)cache % 16 == 0 &&
                    (uintptr_t)out % 16 == 0;
  if (ring && !wide) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  if (!ring) {
    const dim3 grid((unsigned)win, (unsigned)n_batch);
    if (wide)
      window_copy_kernel<float4><<<grid, THREADS, 0, st>>>(
          (const float4*)cache, (const int*)idx, n_batch, height, width, win,
          px_bytes / 16, (float4*)out);
    else
      window_copy_kernel<float><<<grid, THREADS, 0, st>>>(
          (const float*)cache, (const int*)idx, n_batch, height, width, win,
          px_bytes / 4, (float*)out);
    return (int)cudaGetLastError();
  }
  const long long row_bytes = (long long)win * px_bytes;
  const int pieces = (int)((row_bytes + RING_SLOT - 1) / RING_SLOT);
  const int piece_bytes = (int)((row_bytes + pieces - 1) / pieces + 15) / 16 * 16;
  const int smem = 2 * RING_SLOT + 2 * (int)sizeof(uint64_t);
  err = cudaFuncSetAttribute(window_copy_ring_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long units = (long long)n_batch * win * pieces;
  const int grid = (int)(units < sms ? units : sms);
  window_copy_ring_kernel<<<grid, RING_THREADS, smem, st>>>(
      (const unsigned char*)cache, (const int*)idx, n_batch, height, width,
      win, px_bytes, pieces, piece_bytes, (unsigned char*)out);
  return (int)cudaGetLastError();
}

const char* mmlf_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
