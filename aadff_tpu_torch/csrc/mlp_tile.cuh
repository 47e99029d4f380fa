// The PSF MLP on a tile of 64 pixels, shared by the two kernels that run it:
// fused_psf_render.cu (MLP -> per-pixel convolution in one launch) and
// mlp_psf.cu (MLP -> [N, 121] PSF rows in device memory).
//
// A block of NT threads owns P pixels.  Activations are feature-major,
// act[f * P + p], and ping-pong between two [FMAX x P] f32 buffers in shared
// memory.  Each layer is a small GEMM out[f,p] = sum_k W^T[k,f] * in[k,p]:
// every thread keeps an (8 features x 8 pixels) tile of sums in registers, so
// a k step is four 16-byte shared loads for 64 FMAs.  Weights are read
// through L2 in chunks of KC rows, staged into shared memory with cp.async
// and double-buffered, so the next chunk's copy overlaps the current chunk's
// FMAs.  Plain f32 FMA on the CUDA cores.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int P = 64;             // pixels per block
constexpr int NT = 256;           // threads per block
constexpr int KC = 32;            // weight rows per staged chunk
constexpr int FMAX = 256;         // widest (padded) layer
constexpr int MAX_LAYERS = 16;
constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block may use
// Shared memory of the MLP stage: two activation buffers and two weight
// chunks, in floats.
constexpr int MLP_SMEM_FLOATS = 2 * FMAX * P + 2 * KC * FMAX;

// Layout of the packed weights, decided by the Python wrapper
// (ops/fused_render.py:pack_mlp_weights): for layer l, W^T [k, fpad] at
// w_off and the bias [fpad] at b_off (floats), zero-padded from f to fpad
// (128 or 256) outputs.
struct MlpLayout {
  int n_layers;
  int k[MAX_LAYERS];
  int f[MAX_LAYERS];
  int fpad[MAX_LAYERS];
  int w_off[MAX_LAYERS];
  int b_off[MAX_LAYERS];
};

// Read the host layout array (5 ints per layer: k, f, fpad, w_off, b_off)
// into L and check it: 4 inputs, each layer's inputs the previous layer's
// outputs, widths the kernel takes, 16-byte-aligned offsets.  Returns 0 or a
// cudaError_t code.
inline int parse_layout(const int* layout, int n_layers, MlpLayout* L) {
  if (n_layers < 1 || n_layers > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  L->n_layers = n_layers;
  for (int l = 0; l < n_layers; ++l) {
    L->k[l] = layout[5 * l];
    L->f[l] = layout[5 * l + 1];
    L->fpad[l] = layout[5 * l + 2];
    L->w_off[l] = layout[5 * l + 3];
    L->b_off[l] = layout[5 * l + 4];
    const bool ok = L->k[l] >= 1 && L->k[l] <= FMAX &&
                    (L->fpad[l] == 128 || L->fpad[l] == 256) &&
                    L->f[l] >= 1 && L->f[l] <= L->fpad[l] &&
                    (l == 0 ? L->k[l] == 4 : L->k[l] == L->f[l - 1]) &&
                    L->w_off[l] % 4 == 0 && L->b_off[l] % 4 == 0;
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  return 0;
}

__device__ __forceinline__ void stage_chunk(float* dst, const float* src,
                                            int rows, int fpad) {
  const int n4 = rows * fpad / 4;
  for (int i = threadIdx.x; i < n4; i += NT) {
    __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
  }
  __pipeline_commit();
}

// out[f, p] = act(sum_k w[k, f] * in[k, p] + b[f]) for f < 128 * NH, p < P.
// Thread t owns features {fg*4 .. fg*4+3} (+128 when NH == 2) and pixels
// {pg*4 .. pg*4+3, 32+pg*4 .. 32+pg*4+3}, fg = t / 8, pg = t % 8: a warp then
// reads 4 distinct weight vectors and 8 distinct activation vectors per k.
template <int NH>
__device__ void mlp_layer(const float* __restrict__ in,
                          float* __restrict__ out,
                          const float* __restrict__ w,
                          const float* __restrict__ b, int K, bool relu,
                          float* wbuf) {
  constexpr int FP = 128 * NH;
  const int fg = threadIdx.x >> 3;
  const int pg = threadIdx.x & 7;
  float acc[4 * NH][8];
#pragma unroll
  for (int i = 0; i < 4 * NH; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const int nchunk = (K + KC - 1) / KC;
  stage_chunk(wbuf, w, min(KC, K), FP);
  for (int c = 0; c < nchunk; ++c) {
    const int k0 = c * KC;
    const int rows = min(KC, K - k0);
    if (c + 1 < nchunk) {
      stage_chunk(wbuf + ((c + 1) & 1) * KC * FMAX, w + (size_t)(k0 + KC) * FP,
                  min(KC, K - k0 - KC), FP);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const float* ws = wbuf + (c & 1) * KC * FMAX;
#pragma unroll 4
    for (int kk = 0; kk < rows; ++kk) {
      const float4* wrow = reinterpret_cast<const float4*>(ws + kk * FP);
      const float4* hrow = reinterpret_cast<const float4*>(in + (k0 + kk) * P);
      float a[4 * NH];
      float h[8];
      float4 v = wrow[fg];
      a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
      if constexpr (NH == 2) {
        v = wrow[32 + fg];
        a[4] = v.x; a[5] = v.y; a[6] = v.z; a[7] = v.w;
      }
      v = hrow[pg];
      h[0] = v.x; h[1] = v.y; h[2] = v.z; h[3] = v.w;
      v = hrow[8 + pg];
      h[4] = v.x; h[5] = v.y; h[6] = v.z; h[7] = v.w;
#pragma unroll
      for (int i = 0; i < 4 * NH; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], h[j], acc[i][j]);
      }
    }
    __syncthreads();  // every thread is done with this buffer before reuse
  }

#pragma unroll
  for (int i = 0; i < 4 * NH; ++i) {
    const int f = (i < 4) ? fg * 4 + i : 128 + fg * 4 + (i - 4);
    const float bias = b[f];
    float r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      r[j] = acc[i][j] + bias;
      if (relu) r[j] = fmaxf(r[j], 0.f);
    }
    float4* orow = reinterpret_cast<float4*>(out + f * P);
    orow[pg] = make_float4(r[0], r[1], r[2], r[3]);
    orow[8 + pg] = make_float4(r[4], r[5], r[6], r[7]);
  }
}

// Every layer of L on the P pixels of act0 (features 0..3 set by the
// caller).  Leaves the last layer's pre-activation outputs in the returned
// buffer, which is act0 or act1.  Ends with __syncthreads().
__device__ __forceinline__ float* mlp_forward(MlpLayout L,
                                              const float* __restrict__ wpack,
                                              float* act0, float* act1,
                                              float* wbuf) {
  float* cur = act0;
  float* nxt = act1;
  for (int l = 0; l < L.n_layers; ++l) {
    const bool relu = l + 1 < L.n_layers;
    const float* w = wpack + L.w_off[l];
    const float* b = wpack + L.b_off[l];
    if (L.fpad[l] == 256) {
      mlp_layer<2>(cur, nxt, w, b, L.k[l], relu, wbuf);
    } else {
      mlp_layer<1>(cur, nxt, w, b, L.k[l], relu, wbuf);
    }
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  __syncthreads();
  return cur;
}

// Sigmoid, then division by the L1 sum + 1e-12, of the first `taps`
// features of each pixel of the feature-major `act`; the result of pixel p,
// feature f goes to dst[p * pstride + f * fstride].  dst may be act itself
// (pstride 1, fstride P).  One thread per pixel.
__device__ __forceinline__ void sigmoid_l1(const float* act, float* dst,
                                           int taps, int pstride,
                                           int fstride) {
  const int t = threadIdx.x;
  if (t < P) {
    float* row = dst + t * pstride;
    float sum = 0.f;
    for (int f = 0; f < taps; ++f) {
      const float v = 1.f / (1.f + expf(-act[f * P + t]));
      row[f * fstride] = v;
      sum += fabsf(v);
    }
    const float denom = sum + 1e-12f;
    for (int f = 0; f < taps; ++f) row[f * fstride] = row[f * fstride] / denom;
  }
}

}  // namespace
