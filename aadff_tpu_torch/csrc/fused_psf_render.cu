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
//                   no sigmoid and no normalisation; convolution only;
//   pipe            the MLP as two independent half-tile chains (two groups
//                   of half the block's threads, each streaming the weights
//                   for its half of the pixels); the same result as 'full'.
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
// and every hidden activation live in shared memory.
//  * One block owns a tile of TH x TW pixels of one image (4 x 16 with 256
//    threads in f32, 8 x 16 with 512 threads in bf16) and loops over the S
//    frames, so the edge-replicated (TH+10) x (TW+10) x C image halo is
//    loaded once for all frames (the TPU kernel's reuse).  Only foc_z differs
//    between frames; x, y and z are computed once per pixel.
//  * The MLP stage is mlp_tile.cuh, shared with mlp_psf.cu: f32 FMA on the
//    CUDA cores, or bf16 mma.sync on the tensor cores with f32 accumulation.
//    Either way every block streams all the weights from L2 through shared
//    memory once per frame: 1.14 MB in bf16.  With 64 pixels a block that
//    is 9,600 blocks x 8 frames, about 88 GB per main-path stack, more than
//    the 5.7 ms bf16 bound can carry; the bf16 tile is therefore 128 pixels
//    (44 GB).  Wider tiles, wgmma and TMA are the next steps.
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

// Shared memory of one block: NG groups of Stage::kBytes (none for
// 'convonly'), then the image halo (none for 'mlponly').
template <class Stage, int NG, int MODE>
size_t smem_bytes(int C, int ks) {
  constexpr int TH = NG * Stage::GP / TW;
  const size_t groups = MODE == kConvOnly ? 0 : (size_t)NG * Stage::kBytes;
  const size_t halo =
      MODE == kMlpOnly ? 0 : sizeof(float) * C * (TH + ks - 1) * (TW + ks - 1);
  return groups + halo;
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
  __shared__ float zpsf[BP];  // 'convonly': the PSF value of each pixel
  char* smem = reinterpret_cast<char*>(smem4);
  float* halo = reinterpret_cast<float*>(
      smem + (MODE == kConvOnly ? 0 : NG * Stage::kBytes));

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
    if constexpr (MODE == kConvOnly) zpsf[t] = pz * 0.01f;
  }
  const int taps = ks * ks;

  for (int s = 0; s < S; ++s) {
    __syncthreads();  // the previous frame's convolution is done
    if constexpr (MODE != kConvOnly) {
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
      float* res = Stage::run(L, wpack, smem + grp * Stage::kBytes, tl,
                              1 + grp);
      if (tl < GP) {
        float* px_taps = res + tl * Stage::PSTR;
        sigmoid_l1_px(px_taps, Stage::FSTR, px_taps, Stage::FSTR, taps);
      }
      __syncthreads();
    }

    // out[c, y, x] = sum_ij halo[c, y+i, x+j] * psf[i*ks+j, pixel]
    // ('mlponly': out[c, y, x] = psf[c, pixel])
    for (int i = t; i < C * BP; i += BT) {
      const int c = i / BP;
      const int p = i - c * BP;
      const int ty = p / TW;
      const int tx = p - ty * TW;
      const float* psf;
      int fstr;
      if constexpr (MODE == kConvOnly) {
        psf = zpsf + p;
        fstr = 0;
      } else {
        psf = Stage::result(smem + (p / GP) * Stage::kBytes, L.n_layers) +
              (p % GP) * Stage::PSTR;
        fstr = Stage::FSTR;
      }
      float acc;
      if constexpr (MODE == kMlpOnly) {
        acc = psf[c * fstr];
      } else {
        const float* hb = halo + c * hh * hw + ty * hw + tx;
        acc = 0.f;
        for (int a = 0; a < ks; ++a) {
          for (int bb = 0; bb < ks; ++bb) {
            acc = fmaf(hb[a * hw + bb], psf[(a * ks + bb) * fstr], acc);
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

// One group on the whole tile (Full), or two on its halves (Pipe, the
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

}  // namespace

extern "C" {

// img [N,C,H,W], depth_mm [N,H,W], focus_mm [N,S], out [N,S,C,H,W]: f32,
// contiguous, on the current device.  wpack: the packed weights, f32 or
// bf16 (`use_bf16` 0 or 1); layout: host array of 5 ints per layer (k, f,
// fpad, w_off, b_off).  mode: 0 full, 1 mlponly, 2 convonly; pipe 0 or 1;
// a mode other than full, or pipe, takes S = 1 only ('convonly' has no MLP,
// so neither bf16 nor pipe changes it).  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
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
  MlpLayout L;
  const int rc = parse_layout(layout, n_layers, use_bf16 ? 8 : 4, &L);
  if (rc != 0) return rc;
  const int taps = ks * ks;
  if (L.f[n_layers - 1] != taps || C > taps) {
    return (int)cudaErrorInvalidValue;
  }
  if (use_bf16 && L.fpad[n_layers - 1] != 128) {
    return (int)cudaErrorInvalidValue;  // the f32 rows of the last layer
  }

  const cudaStream_t st = (cudaStream_t)stream;
  if (mode == kConvOnly) {
    return launch<F32Full, 1, kConvOnly>(img, depth, focus, wpack, L, out, N,
                                         S, C, H, W, ks, d_min, d_max, st);
  }
  if (use_bf16) {
    return launch_mode<Bf16Full, Bf16Pipe>(mode, pipe, img, depth, focus,
                                           wpack, L, out, N, S, C, H, W, ks,
                                           d_min, d_max, st);
  }
  return launch_mode<F32Full, F32Pipe>(mode, pipe, img, depth, focus, wpack,
                                       L, out, N, S, C, H, W, ks, d_min, d_max,
                                       st);
}

const char* aadff_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
