// The per-pixel tap convolution of the fused render's 'convonly' mode, for
// Hopper (sm_90a): out[n, 0, c, y, x] = sum_{a,b < ks} img_pad[n, c, y+a,
// x+b] * psf(n, y, x), the image edge-padded by (ks-1)/2 and the PSF
// 0.01 * z on every tap, z = clamp01((depth - d_min) / (d_max - d_min)).
//
// Replaces the convonly mode of the Pallas TPU kernel `_kernel` of
// aadff_tpu/ops/pallas_render.py (:90-192; mode='convonly' :154-156, a
// diagnostic that isolates the halo load and the tap convolution; one frame,
// pallas_call at :222).  The fused kernel (fused_psf_render.cu) dispatches
// its mode 2 here, so its C entry point and wrapper are unchanged.
//
// What bounds it on an H100.  Each output and channel does ks^2 multiply-
// adds, one for each tap, as the TPU kernel does: 121 for ks = 11, so one
// 480x640 RGB frame is 223 MFLOP, 3.33 us of f32 FMA at 67 TFLOP/s.  It must
// move the image, the depth map and the output once, 8.6 MB: 2.57 us at
// 3.35 TB/s.  So it is bound by operations, on the CUDA cores.  Tensor cores
// do not apply: every pixel has its own filter, so no matrix product shares
// weights across pixels.  The taps are not folded into a box sum or a
// separable pass: the mode exists to measure the tap convolution.
//
// The design.  Besides the FMAs, the costs are the shared-memory loads of
// the image in the inner loop and the halo brought in before it:
//  * A block of 128 threads owns a 16 x 64 tile of one channel of one image
//    (grid: column tiles, row tiles, N * C): 900 blocks for a 480x640 RGB
//    frame, all resident at once (6-7 an SM).
//  * Each thread owns 2 rows x 4 columns of outputs.  Per image row of its
//    window it loads ks + 3 values into registers with 16-byte shared loads
//    (three float4 and a float2 for ks = 11), and each value feeds up to
//    2 x 4 FMAs: 12 row loads for 968 FMAs.  The 8 PSF values stay in
//    registers.  A quarter warp's 16-byte loads cover 32 consecutive floats
//    of one row: no bank conflicts.
//  * The edge-replicated (16+ks-1) x (64+ks-1) halo comes into shared
//    memory with 4-byte cp.async, row by row, coalesced along W, its clamped
//    columns computed once a thread.  The PSF values are computed (one
//    reciprocal, no division) while the copies fly.
//  * Loops are unrolled at compile time (ks is a template argument, odd, 1
//    to 15), so no integer division and no index arithmetic is left in the
//    inner loop; each output's taps are summed in the plain version's order
//    (rows a, then columns b).
//  * Depth loads and stores are 16-byte, the stores coalesced along W, when
//    W % 4 == 0 and the bases are 16-byte aligned; otherwise scalar.  The
//    ragged edge is masked: any N x H x W is accepted.
// What it does not do: hide the halo load under the FMAs.  Every block
// loads before it computes, and all of them start at once, so the loads add
// to the FMAs' time (PERF.md, section 6; measured by
// aadff_tpu_torch/scripts/psf_conv_phases.py, which builds this file with
// -DPSF_CONV_NO_LOADS: no halo or depth load, the same FMAs and stores).
// Tried and measured slower (PERF.md): 4 x 4 outputs a thread on 32 x 32
// tiles, persistent warps prefetching their next tile, halo rows streamed in
// commit groups, TMA boxes for the halo and the depth, one block per tile
// for all channels with each channel's halo landing on its own mbarrier,
// and fewer resident blocks an SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 16;                // tile rows
constexpr int kTileW = 64;                // tile columns
constexpr int kQ = 2;                     // output rows a thread
constexpr int kR = 4;                     // output columns a thread
constexpr int kCols = kTileW / kR;        // threads across a tile
constexpr int kThreads = kCols * (kTileH / kQ);  // 128
constexpr int kMaxKs = 15;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// n floats from a 16-byte-aligned shared address into registers, as float4
// loads and a float2 for the rest (n is even).
template <int NV>
__device__ __forceinline__ void load_row(const float* src, float (&v)[NV]) {
  static_assert(NV % 2 == 0, "an even window");
#pragma unroll
  for (int i = 0; i + 4 <= NV; i += 4) {
    const float4 f = *reinterpret_cast<const float4*>(src + i);
    v[i] = f.x;
    v[i + 1] = f.y;
    v[i + 2] = f.z;
    v[i + 3] = f.w;
  }
  if constexpr (NV % 4 == 2) {
    const float2 f = *reinterpret_cast<const float2*>(src + NV - 2);
    v[NV - 2] = f.x;
    v[NV - 1] = f.y;
  }
}

template <int KS>
__global__ void __launch_bounds__(kThreads, 8)
psf_conv_kernel(const float* __restrict__ img, const float* __restrict__ depth,
                float* __restrict__ out, int C, int H, int W, float d_min,
                float d_max, bool aligned) {
  constexpr int PAD = (KS - 1) / 2;
  constexpr int HH = kTileH + KS - 1;     // halo rows
  constexpr int HW = kTileW + KS - 1;     // halo columns
  constexpr int HS = (HW + 3) & ~3;       // row stride: 16-byte rows
  constexpr int NV = kR + KS - 1;         // a thread's window of one row
  __shared__ __align__(16) float halo[HH * HS];

  const int t = threadIdx.x;
  const int nc = blockIdx.z;              // n * C + c
  const int n = nc / C;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const size_t plane = (size_t)H * W;

  // the edge-replicated halo, one row a warp at a time
#ifndef PSF_CONV_NO_LOADS
  {
    const float* src = img + (size_t)nc * plane;
    const int lane = t & 31;
    constexpr int kColSteps = (HW + 31) / 32;
    int gx[kColSteps];
#pragma unroll
    for (int k = 0; k < kColSteps; ++k) {
      gx[k] = min(max(x0 - PAD + lane + 32 * k, 0), W - 1);
    }
    for (int r = t >> 5; r < HH; r += kThreads / 32) {
      const float* row = src + (size_t)min(max(y0 - PAD + r, 0), H - 1) * W;
#pragma unroll
      for (int k = 0; k < kColSteps; ++k) {
        if (lane + 32 * k < HW) cp_async4(&halo[r * HS + lane + 32 * k], row + gx[k]);
      }
    }
  }
#endif

  // this thread's outputs and their PSF value 0.01 * z (pixels past the
  // ragged edge are clamped and never stored)
  const int tx = t % kCols;
  const int ty = t / kCols;
  const int oy = y0 + ty * kQ;
  const int ox = x0 + tx * kR;
  const float inv = __frcp_rn(__fsub_rn(d_max, d_min));
  float p[kQ][kR];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const float* drow =
        depth + (size_t)n * plane + (size_t)min(oy + q, H - 1) * W;
    float d[kR];
#ifdef PSF_CONV_NO_LOADS
    for (int j = 0; j < kR; ++j) d[j] = d_min + (float)(oy + q + ox + j);
#else
    if (aligned) {
      const float4 d4 =
          __ldg(reinterpret_cast<const float4*>(drow + min(ox, W - kR)));
      d[0] = d4.x;
      d[1] = d4.y;
      d[2] = d4.z;
      d[3] = d4.w;
    } else {
#pragma unroll
      for (int j = 0; j < kR; ++j) d[j] = __ldg(drow + min(ox + j, W - 1));
    }
#endif
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const float z =
          fminf(fmaxf(__fmul_rn(__fsub_rn(d[j], d_min), inv), 0.f), 1.f);
      p[q][j] = __fmul_rn(z, 0.01f);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // acc[q][j] = sum_{a,b} halo[ty*kQ + q + a][tx*kR + j + b] * p[q][j]:
  // image row r of the window serves output rows q = r - a
  float acc[kQ][kR];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
#pragma unroll
    for (int j = 0; j < kR; ++j) acc[q][j] = 0.f;
  }
  const float* hb = halo + ty * kQ * HS + tx * kR;
#pragma unroll
  for (int r = 0; r < kQ + KS - 1; ++r) {
    float v[NV];
    load_row(hb + r * HS, v);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      if (r - q < 0 || r - q >= KS) continue;
#pragma unroll
      for (int b = 0; b < KS; ++b) {
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          acc[q][j] = fmaf(v[j + b], p[q][j], acc[q][j]);
        }
      }
    }
  }

  float* dst = out + (size_t)nc * plane;
  const bool vec = aligned && ox + kR <= W;
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    if (oy + q >= H) break;
    float* o = dst + (size_t)(oy + q) * W + ox;
    if (vec) {
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
    } else {
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        if (ox + j < W) o[j] = acc[q][j];
      }
    }
  }
}

template <int KS>
int launch(const float* img, const float* depth, float* out, int N, int C,
           int H, int W, float d_min, float d_max, cudaStream_t stream) {
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, N * C);
  // float4 depth loads and stores: 16-byte rows and bases
  const bool aligned = (W & 3) == 0 && (reinterpret_cast<uintptr_t>(depth) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  psf_conv_kernel<KS><<<grid, kThreads, 0, stream>>>(img, depth, out, C, H, W,
                                                     d_min, d_max, aligned);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// img [N,C,H,W], depth_mm [N,H,W], out [N,1,C,H,W]: f32, contiguous, on the
// current device; ks odd, 1 to 15.  Launches on `stream` and returns its
// error (0 on success); it does not synchronise.
int aadff_psf_conv(const float* img, const float* depth, float* out, int N,
                   int C, int H, int W, int ks, float d_min, float d_max,
                   void* stream) {
  if (N < 1 || C < 1 || H < 1 || W < 1 || N * C > 65535 || ks < 1 ||
      ks > kMaxKs || (ks & 1) == 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  switch (ks) {
    case 1: return launch<1>(img, depth, out, N, C, H, W, d_min, d_max, st);
    case 3: return launch<3>(img, depth, out, N, C, H, W, d_min, d_max, st);
    case 5: return launch<5>(img, depth, out, N, C, H, W, d_min, d_max, st);
    case 7: return launch<7>(img, depth, out, N, C, H, W, d_min, d_max, st);
    case 9: return launch<9>(img, depth, out, N, C, H, W, d_min, d_max, st);
    case 11: return launch<11>(img, depth, out, N, C, H, W, d_min, d_max, st);
    case 13: return launch<13>(img, depth, out, N, C, H, W, d_min, d_max, st);
    default: return launch<15>(img, depth, out, N, C, H, W, d_min, d_max, st);
  }
}

}  // extern "C"
