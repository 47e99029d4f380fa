// Fused per-pixel PSF render for Hopper (sm_90a): field -> PSF MLP -> 121
// taps -> per-pixel convolution of the edge-padded image, for every frame of
// a focal stack, in one launch.
//
// Replaces the Pallas TPU kernel `_kernel` of aadff_tpu/ops/pallas_render.py
// (:90-192), in both of its launches: `fused_psf_render_stack` (:292-366, the
// whole focal stack, pallas_call at :336) and `fused_psf_render` (:197-248,
// one frame, pallas_call at :222).  The frame launch is this kernel with S=1.
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
// What this first design does about it.  Nothing but the field inputs, the
// image halo and the output pixels touches device memory: the [H,W,121] PSF
// field and every hidden activation live in shared memory.
//  * One block owns a tile of TH x TW = 64 pixels of one image and loops over
//    the S frames, so the edge-replicated (TH+10) x (TW+10) x C image halo is
//    loaded once for all frames (the TPU kernel's reuse).  Only foc_z differs
//    between frames; x, y and z are computed once per pixel.
//  * The MLP stage is mlp_tile.cuh, shared with mlp_psf.cu: activations
//    ping-pong between two [256 x 64] f32 buffers in dynamic shared memory
//    (64 KB each); each layer is a small GEMM out[f,p] = sum_k W^T[k,f] *
//    in[k,p] in which each of the 256 threads keeps an (8 features x 8
//    pixels) tile of sums in registers, so a k step is four 16-byte shared
//    loads for 64 FMAs.  Weights are read through L2 in chunks of 32 rows,
//    staged into shared memory with cp.async, double-buffered so the next
//    chunk's copy overlaps the current chunk's FMAs.
//  * Plain f32 FMA on the CUDA cores.  TF32/bf16 tensor cores (wgmma) and
//    TMA are later work; the bound above says what they are worth.
// The ragged edge is masked: any H x W is accepted.

#include "mlp_tile.cuh"

namespace {

constexpr int TH = 4;             // tile rows
constexpr int TW = 16;            // tile columns
static_assert(TH * TW == P, "a tile is the MLP stage's P pixels");

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

__global__ void __launch_bounds__(NT, 1)
fused_psf_render_kernel(const float* __restrict__ img,
                        const float* __restrict__ depth,
                        const float* __restrict__ focus,
                        const float* __restrict__ wpack, MlpLayout L,
                        float* __restrict__ out, int S, int C, int H, int W,
                        int ks, float d_min, float d_max) {
  extern __shared__ float4 smem4[];
  float* act0 = reinterpret_cast<float*>(smem4);
  float* act1 = act0 + FMAX * P;
  float* wbuf = act1 + FMAX * P;
  float* halo = wbuf + 2 * KC * FMAX;

  const int t = threadIdx.x;
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int pad = (ks - 1) / 2;
  const int hh = TH + ks - 1;
  const int hw = TW + ks - 1;
  const size_t plane = (size_t)H * W;
  const float range = __fsub_rn(d_max, d_min);

  // Edge-replicated image halo, shared by all S frames.
  for (int i = t; i < C * hh * hw; i += NT) {
    const int c = i / (hh * hw);
    const int r = i - c * hh * hw;
    const int gy = min(max(y0 - pad + r / hw, 0), H - 1);
    const int gx = min(max(x0 - pad + r % hw, 0), W - 1);
    halo[i] = img[((size_t)n * C + c) * plane + (size_t)gy * W + gx];
  }

  // x, y, z of this thread's pixel (pixels past the ragged edge are clamped
  // and never stored).
  float px = 0.f, py = 0.f, pz = 0.f;
  if (t < P) {
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
    if (t < P) {
      const float fz =
          clamp01(__fdiv_rn(__fsub_rn(focus[n * S + s], d_min), range));
      act0[t] = px;
      act0[P + t] = py;
      act0[2 * P + t] = pz;
      act0[3 * P + t] = fz;
    }
    float* cur = mlp_forward(L, wpack, act0, act1, wbuf);

    // Sigmoid, then division by the L1 sum + 1e-12, per pixel, in place.
    sigmoid_l1(cur, cur, taps, 1, P);
    __syncthreads();

    // out[c, y, x] = sum_ij halo[c, y+i, x+j] * psf[i*ks+j, pixel]
    for (int i = t; i < C * P; i += NT) {
      const int c = i / P;
      const int p = i - c * P;
      const int ty = p / TW;
      const int tx = p - ty * TW;
      const float* hb = halo + c * hh * hw + ty * hw + tx;
      float acc = 0.f;
      for (int a = 0; a < ks; ++a) {
        for (int bb = 0; bb < ks; ++bb) {
          acc = fmaf(hb[a * hw + bb], cur[(a * ks + bb) * P + p], acc);
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

}  // namespace

extern "C" {

// img [N,C,H,W], depth_mm [N,H,W], focus_mm [N,S], out [N,S,C,H,W]: f32,
// contiguous, on the current device.  layout: host array of 5 ints per layer
// (k, f, fpad, w_off, b_off).  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
int aadff_fused_psf_render(const float* img, const float* depth,
                           const float* focus, const float* wpack,
                           const int* layout, int n_layers, float* out, int N,
                           int S, int C, int H, int W, int ks, float d_min,
                           float d_max, void* stream) {
  if (N < 1 || S < 1 || C < 1 || H < 1 || W < 1 || ks < 1 || (ks & 1) == 0) {
    return (int)cudaErrorInvalidValue;
  }
  MlpLayout L;
  const int rc = parse_layout(layout, n_layers, &L);
  if (rc != 0) return rc;
  if (L.f[n_layers - 1] != ks * ks) return (int)cudaErrorInvalidValue;

  const size_t smem =
      sizeof(float) * ((size_t)MLP_SMEM_FLOATS +
                       (size_t)C * (TH + ks - 1) * (TW + ks - 1));
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      fused_psf_render_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;

  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N);
  fused_psf_render_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      img, depth, focus, wpack, L, out, S, C, H, W, ks, d_min, d_max);
  return (int)cudaGetLastError();
}

const char* aadff_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
