// Fused per-pixel PSF render for Hopper (sm_90a): field -> PSF MLP -> 121
// taps -> per-pixel convolution of the edge-padded image, for every frame of
// a focal stack, in one launch.
//
// Replaces the Pallas TPU kernel `_kernel` of aadff_tpu/ops/pallas_render.py
// (:90-192), in both of its launches: `fused_psf_render_stack` (:292-366, the
// whole focal stack, pallas_call at :336) and `fused_psf_render` (:197-248,
// one frame, pallas_call at :222).  The frame launch is this kernel with S=1.
// Both of the TPU kernel's compute dtypes are here: f32 (the default) and
// bf16 (`compute_dtype=jnp.bfloat16`, the MLP on the tensor cores), and so
// are its diagnostic knobs (:93-101), for S = 1 as in JAX:
//   mode 'mlponly'  the MLP, sigmoid and L1 norm only (no halo, no
//                   convolution); the output is the first C taps;
//   mode 'convonly' no MLP: the PSF is 0.01 * z broadcast to every tap, with
//                   no sigmoid and no normalisation; convolution only.  It
//                   is a kernel of its own, psf_conv.cu, which the entry
//                   point below launches for mode 2;
//   pipe            the MLP as two independent half-tile chains; the same
//                   result as 'full'.  f32: two groups of half the block's
//                   threads, each streaming the weights for its half of the
//                   pixels.  bf16: the kernel's two consumer warpgroups are
//                   such chains already, so pipe launches 'full'.
//
// What bounds it on an H100.  Per pixel and frame the MLP 4->64->256->8x256
// ->121 costs 571,904 multiply-adds and the 11x11 convolution 363 more, so
// one main-path stack (2 images x 8 frames x 480x640) is 5.63 TFLOP (351.6
// GFLOP per frame).  The bytes it must move are the image, the depth map,
// the 2.3 MB of weights and the [2,8,3,480,640] output: about 69 MB, 21 us
// at 3.35 TB/s.  The kernel is therefore bound by operations: 84 ms in f32 on
// the CUDA cores (67 TFLOP/s), 11 ms in TF32 and 5.7 ms in bf16 on the tensor
// cores (495 / 989 TFLOP/s, dense, H100 SXM at 700 W).
//
// What this design does about it.  Nothing but the field inputs, the image
// halo and the output pixels touches device memory: the [H,W,121] PSF field
// and every hidden activation stay on the SM.  One block owns a tile of
// TH x TW pixels of one image and loops over the S frames, so the
// edge-replicated (TH+10) x (TW+10) x C image halo is loaded once for all
// frames (the TPU kernel's reuse); only foc_z differs between frames, and
// x, y and z are computed once per pixel.  The MLP stage is mlp_tile.cuh,
// shared with mlp_psf.cu:
//  * f32: 4 x 16 pixels, 256 threads, FMA on the CUDA cores (F32Stage).
//  * bf16: 8 x 16 pixels, 384 threads in three warpgroups (wg::): two
//    consumers take turns running wgmma on 4 x 16 pixels each with
//    activations in registers, one producer streams the weights through a
//    ring of 16 KB chunks with bulk copies and mbarriers.  Each SM takes in
//    1.14 MB of weights per tile and frame (44 GB a main-path stack).
//    Multicasting each chunk to a cluster of 2 or 4 neighbouring tiles
//    halves or quarters what leaves L2, but not what each SM takes in, and
//    measured slower (PERF.md, section 6).  Our hypothesis, not measured:
//    that per-SM intake, and the epilogues the turns do not hide, hold the
//    kernel at about half of its bound.  Each consumer convolves
//    its own 64 pixels on its 128 threads: the taps' rows are split
//    between its two halves of 64 threads, whose partial sums meet in
//    shared memory.  That epilogue overlaps the other consumer's wgmma and
//    the ring's copies of the next frame's first chunks.
// The ragged edge is masked: any H x W is accepted.

#include "mlp_tile.cuh"

namespace {

constexpr int TW = 16;            // tile columns; a tile has NG * GP pixels

enum Mode { kFull = 0, kMlpOnly = 1, kConvOnly = 2 };

__device__ __forceinline__ float clamp01(float v) {
  return fminf(fmaxf(v, 0.f), 1.f);
}

// Element i of jnp.linspace(start, stop, num), with its rounding:
// start * (1 - i/div) + stop * i/div in f32, the last element exactly stop.
__device__ __forceinline__ float linspace_at(float start, float stop, int num,
                                             int i) {
  if (num == 1) return start;
  if (i == num - 1) return stop;
  const float t = __fdiv_rn((float)i, (float)(num - 1));
  return __fadd_rn(__fmul_rn(start, __fsub_rn(1.f, t)), __fmul_rn(stop, t));
}

// Shared memory of one block: NG groups of Stage::kBytes, then the image
// halo (none for 'mlponly').
template <class Stage, int NG, int MODE>
size_t smem_bytes(int C, int ks) {
  constexpr int TH = NG * Stage::GP / TW;
  const size_t halo =
      MODE == kMlpOnly ? 0 : sizeof(float) * C * (TH + ks - 1) * (TW + ks - 1);
  return (size_t)NG * Stage::kBytes + halo;
}

// A block of NG groups of Stage::GT threads owns a tile of TH x TW pixels,
// NG * Stage::GP in all.
template <class Stage, int NG, int MODE>
__global__ void __launch_bounds__(NG * Stage::GT, 1)
fused_psf_render_kernel(const float* __restrict__ img,
                        const float* __restrict__ depth,
                        const float* __restrict__ focus,
                        const void* __restrict__ wpack,
                        const __grid_constant__ MlpLayout L,
                        float* __restrict__ out, int S, int C, int H, int W,
                        int ks, float d_min, float d_max) {
  constexpr int GP = Stage::GP;
  constexpr int GT = Stage::GT;
  constexpr int BP = NG * GP;   // pixels of the block
  constexpr int BT = NG * GT;   // threads of the block
  constexpr int TH = BP / TW;
  static_assert(TH * TW == BP, "a tile is the block's pixels");
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  float* halo = reinterpret_cast<float*>(smem + NG * Stage::kBytes);

  const int t = threadIdx.x;
  const int grp = t / GT;
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int pad = (ks - 1) / 2;
  const int hh = TH + ks - 1;
  const int hw = TW + ks - 1;
  const size_t plane = (size_t)H * W;
  const float range = __fsub_rn(d_max, d_min);

  // Edge-replicated image halo, shared by all S frames.
  if constexpr (MODE != kMlpOnly) {
    for (int i = t; i < C * hh * hw; i += BT) {
      const int c = i / (hh * hw);
      const int r = i - c * hh * hw;
      const int gy = min(max(y0 - pad + r / hw, 0), H - 1);
      const int gx = min(max(x0 - pad + r % hw, 0), W - 1);
      halo[i] = img[((size_t)n * C + c) * plane + (size_t)gy * W + gx];
    }
  }

  // x, y, z of this thread's pixel (pixels past the ragged edge are clamped
  // and never stored).
  float px = 0.f, py = 0.f, pz = 0.f;
  if (t < BP) {
    const int gy = min(y0 + t / TW, H - 1);
    const int gx = min(x0 + t % TW, W - 1);
    px = linspace_at(-1.f, 1.f, W, gx);
    py = linspace_at(1.f, -1.f, H, gy);
    const float d = depth[(size_t)n * plane + (size_t)gy * W + gx];
    pz = clamp01(__fdiv_rn(__fsub_rn(d, d_min), range));
  }
  const int taps = ks * ks;

  for (int s = 0; s < S; ++s) {
    __syncthreads();  // the previous frame's convolution is done
    if (t < BP) {
      const float fz =
          clamp01(__fdiv_rn(__fsub_rn(focus[n * S + s], d_min), range));
      Stage::put_field(smem + (t / GP) * Stage::kBytes, t % GP, px, py, pz,
                       fz);
    }
    __syncthreads();
    // each group runs the MLP on its pixels, then the sigmoid and the L1
    // normalisation in place, one thread per pixel
    const int tl = t - grp * GT;
    float* res = Stage::run(L, wpack, smem + grp * Stage::kBytes, tl, 1 + grp);
    if (tl < GP) {
      float* px_taps = res + tl * Stage::PSTR;
      sigmoid_l1_px(px_taps, Stage::FSTR, px_taps, Stage::FSTR, taps);
    }
    __syncthreads();

    // out[c, y, x] = sum_ij halo[c, y+i, x+j] * psf[i*ks+j, pixel]
    // ('mlponly': out[c, y, x] = psf[c, pixel])
    for (int i = t; i < C * BP; i += BT) {
      const int c = i / BP;
      const int p = i - c * BP;
      const int ty = p / TW;
      const int tx = p - ty * TW;
      const float* psf =
          Stage::result(smem + (p / GP) * Stage::kBytes, L.n_layers) +
          (p % GP) * Stage::PSTR;
      float acc;
      if constexpr (MODE == kMlpOnly) {
        acc = psf[c * Stage::FSTR];
      } else {
        const float* hb = halo + c * hh * hw + ty * hw + tx;
        acc = 0.f;
        for (int a = 0; a < ks; ++a) {
          for (int bb = 0; bb < ks; ++bb) {
            acc = fmaf(hb[a * hw + bb], psf[(a * ks + bb) * Stage::FSTR], acc);
          }
        }
      }
      const int gy = y0 + ty;
      const int gx = x0 + tx;
      if (gy < H && gx < W) {
        out[(((size_t)n * S + s) * C + c) * plane + (size_t)gy * W + gx] = acc;
      }
    }
  }
}

// The bf16 kernel (mlp_tile.cuh, wg::): a tile of 8 x 16 pixels, consumer
// c on rows 4c .. 4c+3.  MODE kFull or kMlpOnly.
template <int MODE>
__global__ void __launch_bounds__(wg::kThreads, 1)
fused_psf_render_wg(const float* __restrict__ img,
                    const float* __restrict__ depth,
                    const float* __restrict__ focus,
                    const void* __restrict__ wpack,
                    const __grid_constant__ MlpLayout L,
                    float* __restrict__ out, int S, int C, int H, int W,
                    int ks, float d_min, float d_max, int nchunks,
                    int nbias) {
  constexpr int TH = wg::kPixels / TW;
  extern __shared__ __align__(1024) char smem_raw[];
  char* sm = wg::aligned_smem(smem_raw);
  const int taps = ks * ks;
  const int hh = TH + ks - 1;
  const int hw = TW + ks - 1;
  const wg::Smem m = wg::smem_plan(nbias, taps, MODE == kFull ? 4 * C * 64 : 0,
                                   MODE == kFull ? C * hh * hw : 0);
  const wg::Ring ring = wg::ring_init(sm, m);
  const int t = threadIdx.x;

  if (t >= 256) {  // the producer warpgroup
    wg::setmaxnreg_dec<wg::kProducerRegs>();
    if (t == 256) {
      const bf16* w = static_cast<const bf16*>(wpack) + L.w_off[0];
      wg::produce(ring, reinterpret_cast<const char*>(w), nchunks, S);
    }
  } else {  // the two consumer warpgroups
    wg::setmaxnreg_inc<wg::kConsumerRegs>();
    const int n = blockIdx.z;
    const int y0 = blockIdx.y * TH;
    const int x0 = blockIdx.x * TW;
    const int pad = (ks - 1) / 2;
    const size_t plane = (size_t)H * W;
    const float range = __fsub_rn(d_max, d_min);
    float* bias = reinterpret_cast<float*>(sm + m.bias);
    float* halo = reinterpret_cast<float*>(sm + m.halo);
    const float* gbias = reinterpret_cast<const float*>(
        static_cast<const bf16*>(wpack) + L.b_off[0]);
    for (int i = t; i < nbias; i += 256) bias[i] = gbias[i];
    if constexpr (MODE == kFull) {
      for (int i = t; i < C * hh * hw; i += 256) {
        const int c = i / (hh * hw);
        const int r = i - c * hh * hw;
        const int gy = min(max(y0 - pad + r / hw, 0), H - 1);
        const int gx = min(max(x0 - pad + r % hw, 0), W - 1);
        halo[i] = img[((size_t)n * C + c) * plane + (size_t)gy * W + gx];
      }
    }
    group_sync(wg::kBarConsumers, 256);

    const int c = t >> 7;   // consumer
    const int tw = t & 127;
    const int bar = 2 + c;
    // x, y, z of this thread's two MLP pixels (tile pixel 64c + row and
    // + 8; pixels past the ragged edge are clamped and never stored)
    float fld[2][4];
    const int row = 16 * (tw >> 5) + ((tw & 31) >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = 64 * c + row + 8 * h;
      const int gy = min(y0 + p / TW, H - 1);
      const int gx = min(x0 + p % TW, W - 1);
      fld[h][0] = linspace_at(-1.f, 1.f, W, gx);
      fld[h][1] = linspace_at(1.f, -1.f, H, gy);
      const float d = depth[(size_t)n * plane + (size_t)gy * W + gx];
      fld[h][2] = clamp01(__fdiv_rn(__fsub_rn(d, d_min), range));
    }
    float* psf =
        reinterpret_cast<float*>(sm + m.psf) + c * wg::psf_floats(taps);
    float* part = reinterpret_cast<float*>(sm + m.part) + c * 2 * C * 64;
    // this thread's pixel in the epilogue, and its half of the taps' rows
    const int p = tw & 63;
    const int half = tw >> 6;
    const int ty = (64 * c + p) / TW;
    const int tx = (64 * c + p) % TW;
    const int a_lo = half ? (ks + 1) / 2 : 0;
    const int a_hi = half ? ks : (ks + 1) / 2;

    wg::Pos pos;
    wg::Turn turn(c);
    for (int s = 0; s < S; ++s) {
      fld[0][3] = fld[1][3] =
          clamp01(__fdiv_rn(__fsub_rn(focus[n * S + s], d_min), range));
      wg::run_mlp(L, ring, pos, turn, bias, fld[0], fld[1], psf, taps, tw);
      group_sync(bar, 128);
      float* dst = out + ((size_t)n * S + s) * C * plane;
      if constexpr (MODE == kMlpOnly) {
        // out[c, y, x] = psf[pixel, c]
        for (int i = tw; i < C * 64; i += 128) {
          const int cc = i >> 6;
          const int pp = i & 63;
          const int py = y0 + (64 * c + pp) / TW;
          const int px = x0 + (64 * c + pp) % TW;
          if (py < H && px < W) {
            dst[cc * plane + (size_t)py * W + px] = psf[pp * taps + cc];
          }
        }
      } else {
        // out[c, y, x] = sum_ab halo[c, y+a, x+b] * psf[pixel, a*ks+b]:
        // each half of the threads sums its rows a, then the two partial
        // sums of a pixel are added
        const float* pp = psf + p * taps;
        for (int cc = 0; cc < C; ++cc) {
          const float* hb = halo + cc * hh * hw + ty * hw + tx;
          float acc = 0.f;
          for (int a = a_lo; a < a_hi; ++a) {
            for (int b = 0; b < ks; ++b) {
              acc = fmaf(hb[a * hw + b], pp[a * ks + b], acc);
            }
          }
          part[(half * C + cc) * 64 + p] = acc;
        }
        group_sync(bar, 128);
        for (int i = tw; i < C * 64; i += 128) {
          const int cc = i >> 6;
          const int pp = i & 63;
          const int py = y0 + (64 * c + pp) / TW;
          const int px = x0 + (64 * c + pp) % TW;
          if (py < H && px < W) {
            dst[cc * plane + (size_t)py * W + px] =
                part[cc * 64 + pp] + part[(C + cc) * 64 + pp];
          }
        }
      }
      group_sync(bar, 128);
    }
    turn.finish();
  }
}

template <class Stage, int NG, int MODE>
int launch(const float* img, const float* depth, const float* focus,
           const void* wpack, const MlpLayout& L, float* out, int N, int S,
           int C, int H, int W, int ks, float d_min, float d_max,
           cudaStream_t stream) {
  constexpr int TH = NG * Stage::GP / TW;
  const size_t smem = smem_bytes<Stage, NG, MODE>(C, ks);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidConfiguration;
  auto kernel = fused_psf_render_kernel<Stage, NG, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N);
  kernel<<<grid, NG * Stage::GT, smem, stream>>>(
      img, depth, focus, wpack, L, out, S, C, H, W, ks, d_min, d_max);
  return (int)cudaGetLastError();
}

// f32: one group on the whole tile (Full), or two on its halves (Pipe, the
// `pipe` diagnostic).
template <class Full, class Pipe>
int launch_mode(int mode, int pipe, const float* img, const float* depth,
                const float* focus, const void* wpack, const MlpLayout& L,
                float* out, int N, int S, int C, int H, int W, int ks,
                float d_min, float d_max, cudaStream_t stream) {
  static_assert(2 * Pipe::GP == Full::GP, "the same tile either way");
#define AADFF_LAUNCH(STAGE, NG, MODE)                                          \
  launch<STAGE, NG, MODE>(img, depth, focus, wpack, L, out, N, S, C, H, W, ks, \
                          d_min, d_max, stream)
  if (mode == kFull) {
    return pipe ? AADFF_LAUNCH(Pipe, 2, kFull) : AADFF_LAUNCH(Full, 1, kFull);
  }
  return pipe ? AADFF_LAUNCH(Pipe, 2, kMlpOnly)
              : AADFF_LAUNCH(Full, 1, kMlpOnly);
#undef AADFF_LAUNCH
}

// The bf16 kernel.
template <int MODE>
int launch_wg(const float* img, const float* depth, const float* focus,
              const void* wpack, const MlpLayout& L, float* out, int N, int S,
              int C, int H, int W, int ks, float d_min, float d_max,
              int nchunks, int nbias, cudaStream_t stream) {
  constexpr int TH = wg::kPixels / TW;
  const int halo = C * (TH + ks - 1) * (TW + ks - 1);
  const wg::Smem m = wg::smem_plan(nbias, ks * ks,
                                   MODE == kFull ? 4 * C * 64 : 0,
                                   MODE == kFull ? halo : 0);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N);
  return wg::launch(fused_psf_render_wg<MODE>, grid, (size_t)m.total, stream,
                    img, depth, focus, wpack, L, out, S, C, H, W, ks, d_min,
                    d_max, nchunks, nbias);
}

}  // namespace

extern "C" {

// psf_conv.cu: the 'convonly' kernel.
int aadff_psf_conv(const float* img, const float* depth, float* out, int N,
                   int C, int H, int W, int ks, float d_min, float d_max,
                   void* stream);

// img [N,C,H,W], depth_mm [N,H,W], focus_mm [N,S], out [N,S,C,H,W]: f32,
// contiguous, on the current device.  wpack: the packed weights, f32 or
// bf16 (`use_bf16` 0 or 1); layout: host array of 5 ints per layer (k, f,
// fpad, w_off, b_off).  mode: 0 full, 1 mlponly, 2 convonly; pipe 0 or 1;
// a mode other than full, or pipe, takes S = 1 only.  'convonly' has no
// MLP: it reads neither wpack nor layout (either may be null), and neither
// bf16 nor pipe changes it; it launches psf_conv.cu (odd ks up to 15).  In
// bf16, pipe is 'full': its two consumer warpgroups are the two half-tile
// chains.  Launches on `stream` and returns its error (0 on success); it
// does not synchronise.
int aadff_fused_psf_render(const float* img, const float* depth,
                           const float* focus, const void* wpack,
                           const int* layout, int n_layers, float* out, int N,
                           int S, int C, int H, int W, int ks, float d_min,
                           float d_max, int use_bf16, int mode, int pipe,
                           void* stream) {
  if (N < 1 || S < 1 || C < 1 || H < 1 || W < 1 || ks < 1 || (ks & 1) == 0 ||
      mode < kFull || mode > kConvOnly || (use_bf16 != 0 && use_bf16 != 1) ||
      (pipe != 0 && pipe != 1) || ((mode != kFull || pipe) && S != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (mode == kConvOnly) {
    return aadff_psf_conv(img, depth, out, N, C, H, W, ks, d_min, d_max,
                          stream);
  }
  MlpLayout L;
  int nchunks = 0, nbias = 0;
  const int rc = use_bf16
                     ? wg::parse_wg_layout(layout, n_layers, &L, &nchunks,
                                           &nbias)
                     : parse_layout(layout, n_layers, 4, &L);
  if (rc != 0) return rc;
  const int taps = ks * ks;
  if (L.f[n_layers - 1] != taps || C > taps) {
    return (int)cudaErrorInvalidValue;
  }

  const cudaStream_t st = (cudaStream_t)stream;
  if (use_bf16) {
    return mode == kFull
               ? launch_wg<kFull>(img, depth, focus, wpack, L, out, N, S, C,
                                  H, W, ks, d_min, d_max, nchunks, nbias, st)
               : launch_wg<kMlpOnly>(img, depth, focus, wpack, L, out, N, S,
                                     C, H, W, ks, d_min, d_max, nchunks,
                                     nbias, st);
  }
  return launch_mode<F32Full, F32Pipe>(mode, pipe, img, depth, focus, wpack,
                                       L, out, N, S, C, H, W, ks, d_min, d_max,
                                       st);
}

const char* aadff_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
