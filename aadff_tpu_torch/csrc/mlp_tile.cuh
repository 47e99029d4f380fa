// The PSF MLP on a tile of 64 pixels, shared by the two kernels that run it:
// fused_psf_render.cu (MLP -> per-pixel convolution in one launch) and
// mlp_psf.cu (MLP -> [N, 121] PSF rows in device memory).
//
// Two stages compute the same 11 layers; a kernel takes one of them as a
// template argument (a "Stage"):
//
//  * F32Stage: plain f32 FMA on the CUDA cores (the default).  Activations
//    are feature-major, act[f * GP + p], and ping-pong between two
//    [FMAX x GP] f32 buffers in shared memory.  Each layer is a small GEMM
//    out[f,p] = sum_k W^T[k,f] * in[k,p]: every thread keeps an (8 features
//    x 8 pixels) tile of sums in registers, so a k step is four 16-byte
//    shared loads for 64 FMAs.  Weights are read through L2 in chunks of KC
//    rows, staged into shared memory with cp.async and double-buffered, so
//    the next chunk's copy overlaps the current chunk's FMAs.
//
//  * Bf16Stage: the TPU kernel's compute_dtype=bf16 (pallas_render.py
//    :137-150, pallas_mlp.py:40-57) on the tensor cores.  Every layer's input
//    is rounded to bf16 (round to nearest even), the field included; weights
//    are rounded once by the wrapper; products accumulate in f32, then the
//    f32 bias and ReLU.  Activations live in shared memory as bf16,
//    pixel-major act[p * AS + k], so storing a layer's output *is* the cast
//    to bf16 of the next layer's input.  The last layer's pre-activation
//    stays f32 (sigmoid and the L1 normalisation run in f32).  A layer is
//    out^T[p, f] = sum_k in^T[p, k] * W^T[k, f] with
//    mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32: A = 16 pixels x 16 k from
//    the activations, B = 16 k x 8 features from W [f, k] (k contiguous),
//    both loaded with ldmatrix.x4.  Each warp owns up to 64 pixels and a
//    slice of the features, so it keeps 64 f32 sums in registers.  The
//    first layer's K = 4 is zero-padded to 16 (in the packed weights and in
//    the activations).  Weights are staged in chunks of KCW k-columns with
//    cp.async, double-buffered.  Rows of both buffers are padded by 16 bytes
//    so the 8 row addresses of an ldmatrix fall in distinct banks.
//
// A stage runs on a *group* of GT threads that owns GP pixels, with its own
// activation and weight buffers and its own named barrier.  The production
// configurations are one group a block: 256 threads on 64 pixels in f32,
// 512 threads on 128 pixels in bf16 (every block streams all the weights
// through shared memory once per frame, so more pixels a block means fewer
// bytes of weights a pixel).  The `pipe` diagnostic of the fused kernel runs
// two groups, each on half the block's pixels: two independent MLP chains,
// each streaming the weights for its half of the tile (the TPU kernel's two
// half-tile chains).  The arithmetic of each output element is the same in
// every configuration.

#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P = 64;             // pixels per f32 block (bf16: 2 * P)
constexpr int NT = 256;           // threads per f32 block (bf16: 2 * NT)
constexpr int KC = 32;            // f32 weight rows per staged chunk
constexpr int FMAX = 256;         // widest (padded) layer
constexpr int MAX_LAYERS = 16;
constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block may use

// bf16 stage geometry (elements of 2 bytes)
constexpr int KCB = 64;           // weight k-columns per staged chunk
constexpr int AS = FMAX + 8;      // activation row stride: 528 bytes
constexpr int FS = 129;           // f32 row stride of the last layer (odd)
static_assert(4 * FS <= 2 * AS, "the last layer's f32 rows fit a bf16 row");

using bf16 = __nv_bfloat16;

// Layout of the packed weights, decided by the Python wrapper
// (ops/fused_render.py:pack_mlp_weights).  For layer l, outputs f are
// zero-padded to fpad (128 or 256), and w_off / b_off count elements of the
// buffer's type:
//   f32:  W^T [k, fpad] at w_off, bias [fpad] f32 at b_off;
//   bf16: W [fpad, kpad] at w_off (kpad = k rounded up to 16, zero-padded),
//         bias [fpad] f32 at b_off (two bf16 slots per float).
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
// outputs, widths the kernels take, 16-byte-aligned offsets (`align`
// elements: 4 for f32, 8 for bf16).  Returns 0 or a cudaError_t code.
inline int parse_layout(const int* layout, int n_layers, int align,
                        MlpLayout* L) {
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
                    L->w_off[l] % align == 0 && L->b_off[l] % align == 0;
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// Barrier `bar` over the `nthreads` threads of one group (bar 0 is
// __syncthreads(); groups use 1 and 2).
__device__ __forceinline__ void group_sync(int bar, int nthreads) {
  asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(nthreads) : "memory");
}

// Sigmoid, then division by the L1 sum + 1e-12, of the `taps` values
// src[f * sf] of one pixel; the results go to dst[f * df] (dst may be src).
__device__ __forceinline__ void sigmoid_l1_px(const float* src, int sf,
                                              float* dst, int df, int taps) {
  float sum = 0.f;
  for (int f = 0; f < taps; ++f) {
    const float v = 1.f / (1.f + expf(-src[f * sf]));
    dst[f * df] = v;
    sum += fabsf(v);
  }
  const float denom = sum + 1e-12f;
  for (int f = 0; f < taps; ++f) dst[f * df] = dst[f * df] / denom;
}

// ---------------------------------------------------------------- f32 ----

template <int GT>
__device__ __forceinline__ void stage_chunk(float* dst, const float* src,
                                            int rows, int fpad, int tl) {
  const int n4 = rows * fpad / 4;
  for (int i = tl; i < n4; i += GT) {
    __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
  }
  __pipeline_commit();
}

// out[f, p] = act(sum_k w[k, f] * in[k, p] + b[f]) for f < 128 * NH, p < GP.
// With PG = GP / 8 pixel groups, thread tl owns features {fg*4 .. fg*4+3}
// (+128 when NH == 2) and pixels {pg*4 .. pg*4+3, GP/2+pg*4 .. GP/2+pg*4+3},
// fg = tl / PG, pg = tl % PG.
template <int NH, int GP, int GT, int KCF>
__device__ void mlp_layer(const float* __restrict__ in,
                          float* __restrict__ out,
                          const float* __restrict__ w,
                          const float* __restrict__ b, int K, bool relu,
                          float* wbuf, int tl, int bar) {
  constexpr int FP = 128 * NH;
  constexpr int PG = GP / 8;
  static_assert(GT / PG == 32, "32 groups of 4 features");
  const int fg = tl / PG;
  const int pg = tl % PG;
  float acc[4 * NH][8];
#pragma unroll
  for (int i = 0; i < 4 * NH; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const int nchunk = (K + KCF - 1) / KCF;
  stage_chunk<GT>(wbuf, w, min(KCF, K), FP, tl);
  for (int c = 0; c < nchunk; ++c) {
    const int k0 = c * KCF;
    const int rows = min(KCF, K - k0);
    if (c + 1 < nchunk) {
      stage_chunk<GT>(wbuf + ((c + 1) & 1) * KCF * FMAX,
                      w + (size_t)(k0 + KCF) * FP, min(KCF, K - k0 - KCF), FP,
                      tl);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    group_sync(bar, GT);
    const float* ws = wbuf + (c & 1) * KCF * FMAX;
#pragma unroll 4
    for (int kk = 0; kk < rows; ++kk) {
      const float4* wrow = reinterpret_cast<const float4*>(ws + kk * FP);
      const float4* hrow = reinterpret_cast<const float4*>(in + (k0 + kk) * GP);
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
      v = hrow[PG + pg];
      h[4] = v.x; h[5] = v.y; h[6] = v.z; h[7] = v.w;
#pragma unroll
      for (int i = 0; i < 4 * NH; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], h[j], acc[i][j]);
      }
    }
    group_sync(bar, GT);  // every thread is done with this buffer before reuse
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
    float4* orow = reinterpret_cast<float4*>(out + f * GP);
    orow[pg] = make_float4(r[0], r[1], r[2], r[3]);
    orow[PG + pg] = make_float4(r[4], r[5], r[6], r[7]);
  }
}

// A group's shared memory: act0 [FMAX x GP], act1 [FMAX x GP], two weight
// chunks [KCF x FMAX], all f32.
template <int GP_, int GT_, int KCF>
struct F32Stage {
  static constexpr int GP = GP_;
  static constexpr int GT = GT_;
  static constexpr int kBytes = 4 * (2 * FMAX * GP + 2 * KCF * FMAX);
  // the last layer's outputs: element (p, f) at result[p * PSTR + f * FSTR]
  static constexpr int PSTR = 1;
  static constexpr int FSTR = GP;

  __device__ static float* act(char* region, int i) {
    return reinterpret_cast<float*>(region) + i * FMAX * GP;
  }
  // Input features (x, y, z, foc_z) of pixel pl of the group.
  __device__ static void put_field(char* region, int pl, float x, float y,
                                   float z, float fz) {
    float* a = act(region, 0);
    a[pl] = x;
    a[GP + pl] = y;
    a[2 * GP + pl] = z;
    a[3 * GP + pl] = fz;
  }
  // The buffer that holds the last layer's pre-activations, and the other.
  __device__ static float* result(char* region, int n_layers) {
    return act(region, n_layers & 1);
  }
  __device__ static float* spare(char* region, int n_layers) {
    return act(region, (n_layers & 1) ^ 1);
  }
  // Every layer on the group's pixels; ends with the group's barrier.
  __device__ __forceinline__ static float* run(const MlpLayout& L,
                                               const void* wpack_,
                                               char* region, int tl, int bar) {
    const float* wpack = static_cast<const float*>(wpack_);
    float* cur = act(region, 0);
    float* nxt = act(region, 1);
    float* wbuf = act(region, 2);
    for (int l = 0; l < L.n_layers; ++l) {
      const bool relu = l + 1 < L.n_layers;
      const float* w = wpack + L.w_off[l];
      const float* b = wpack + L.b_off[l];
      if (L.fpad[l] == 256) {
        mlp_layer<2, GP, GT, KCF>(cur, nxt, w, b, L.k[l], relu, wbuf, tl, bar);
      } else {
        mlp_layer<1, GP, GT, KCF>(cur, nxt, w, b, L.k[l], relu, wbuf, tl, bar);
      }
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    group_sync(bar, GT);
    return cur;
  }
};

// --------------------------------------------------------------- bf16 ----

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a * b on a 16 x 8 tile, bf16 inputs, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Columns [k0, k0 + kc) of W [fpad, kpad] into dst [fpad x (KCW + 8)].
template <int GT, int KCW>
__device__ __forceinline__ void stage_chunk_bf16(bf16* dst, const bf16* w,
                                                 int kpad, int k0, int kc,
                                                 int fpad, int tl) {
  constexpr int WSW = KCW + 8;
  const int per_row = kc / 8;  // 16-byte pieces
  const int n = fpad * per_row;
  for (int i = tl; i < n; i += GT) {
    const int f = i / per_row;
    const int j = i - f * per_row;
    __pipeline_memcpy_async(dst + f * WSW + j * 8,
                            w + (size_t)f * kpad + k0 + j * 8, 16);
  }
  __pipeline_commit();
}

// One layer on GP pixels: out^T[p, f] = sum_k in^T[p, k] * W[f, k] + b[f].
// The group's warps form a WM x WN grid: warp (wm, wn) owns pixels
// [wm * 64, (wm + 1) * 64) (all GP when GP < 64) and features
// [wn * NN * 8, (wn + 1) * NN * 8).  Weights are staged KCW k-columns at a
// time.  Hidden layers store relu(.) as bf16 into out_bf [GP x AS]; the
// last layer stores f32 into out_f [GP x FS].
template <int FP, int GP, int GT, int KCW>
__device__ void mma_layer(const bf16* __restrict__ in,
                          bf16* out_bf, float* out_f,
                          const bf16* __restrict__ w,
                          const float* __restrict__ b, int K, bf16* wbuf,
                          int tl, int bar) {
  constexpr int WSW = KCW + 8;
  constexpr int NW = GT / 32;
  constexpr int WM = GP >= 64 ? GP / 64 : 1;  // warps along the pixels
  constexpr int WN = NW / WM;                 // warps along the features
  constexpr int MT = GP / (16 * WM);          // 16-pixel tiles per warp
  constexpr int NN = FP / (8 * WN);           // 8-feature tiles per warp
  static_assert(WM * WN == NW && MT >= 1, "warps tile the pixels");
  static_assert(NN % 2 == 0, "ldmatrix.x4 loads two feature tiles");
  const int warp = tl >> 5;
  const int lane = tl & 31;
  const int m0 = (warp / WN) * MT * 16;
  const int n0 = (warp % WN) * NN * 8;
  float acc[MT][NN][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NN; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
    }
  }
  // ldmatrix row addresses of this lane: A rows are pixels, B rows features
  const int a_row = lane & 15;
  const int a_col = (lane >> 4) * 8;
  const int b_row = ((lane >> 4) << 3) + (lane & 7);
  const int b_col = ((lane >> 3) & 1) * 8;

  const int kpad = (K + 15) & ~15;
  const int nchunk = (kpad + KCW - 1) / KCW;
  stage_chunk_bf16<GT, KCW>(wbuf, w, kpad, 0, min(KCW, kpad), FP, tl);
  for (int c = 0; c < nchunk; ++c) {
    const int k0 = c * KCW;
    const int kc = min(KCW, kpad - k0);
    if (c + 1 < nchunk) {
      stage_chunk_bf16<GT, KCW>(wbuf + ((c + 1) & 1) * FMAX * WSW, w, kpad,
                                k0 + KCW, min(KCW, kpad - k0 - KCW), FP, tl);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    group_sync(bar, GT);
    const bf16* ws = wbuf + (c & 1) * FMAX * WSW;
    for (int kk = 0; kk < kc; kk += 16) {
      uint32_t a[MT][4];
      uint32_t bq[NN][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        ldmatrix_x4(a[mt], in + (m0 + mt * 16 + a_row) * AS + k0 + kk + a_col);
      }
#pragma unroll
      for (int j = 0; j < NN / 2; ++j) {
        uint32_t r[4];
        ldmatrix_x4(r, ws + (n0 + 16 * j + b_row) * WSW + kk + b_col);
        bq[2 * j][0] = r[0];
        bq[2 * j][1] = r[1];
        bq[2 * j + 1][0] = r[2];
        bq[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NN; ++nt) mma_bf16(acc[mt][nt], a[mt], bq[nt]);
      }
    }
    group_sync(bar, GT);  // every warp is done with this buffer before reuse
  }

  // accumulator (q = 0, 1): pixel g, features 2t, 2t+1; (q = 2, 3): pixel g+8
  const int g = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NN; ++nt) {
    const int f = n0 + nt * 8 + 2 * t4;
    const float b0 = b[f];
    const float b1 = b[f + 1];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = m0 + mt * 16 + g + 8 * h;
        const float v0 = acc[mt][nt][2 * h] + b0;
        const float v1 = acc[mt][nt][2 * h + 1] + b1;
        if (out_f != nullptr) {
          out_f[p * FS + f] = v0;
          out_f[p * FS + f + 1] = v1;
        } else {
          *reinterpret_cast<__nv_bfloat162*>(out_bf + p * AS + f) =
              __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        }
      }
    }
  }
}

// A group's shared memory: act0 [GP x AS], act1 [GP x AS], two weight
// chunks [FMAX x (KCW + 8)], all bf16.  The last layer's f32 outputs
// [GP x FS] overwrite the activation buffer it writes.
template <int GP_, int GT_, int KCW = KCB>
struct Bf16Stage {
  static constexpr int GP = GP_;
  static constexpr int GT = GT_;
  static constexpr int kBytes = 2 * (2 * GP * AS + 2 * FMAX * (KCW + 8));
  static constexpr int PSTR = FS;
  static constexpr int FSTR = 1;

  __device__ static bf16* act(char* region, int i) {
    return reinterpret_cast<bf16*>(region) + i * GP * AS;
  }
  // Input features of pixel pl, rounded to bf16, and the zero padding of the
  // first layer's K = 4 to 16.
  __device__ static void put_field(char* region, int pl, float x, float y,
                                   float z, float fz) {
    bf16* row = act(region, 0) + pl * AS;
    *reinterpret_cast<__nv_bfloat162*>(row) = __floats2bfloat162_rn(x, y);
    *reinterpret_cast<__nv_bfloat162*>(row + 2) = __floats2bfloat162_rn(z, fz);
    *reinterpret_cast<uint2*>(row + 4) = make_uint2(0u, 0u);
    *reinterpret_cast<uint4*>(row + 8) = make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ static float* result(char* region, int n_layers) {
    return reinterpret_cast<float*>(act(region, n_layers & 1));
  }
  __device__ static float* spare(char* region, int n_layers) {
    return reinterpret_cast<float*>(act(region, (n_layers & 1) ^ 1));
  }
  __device__ __forceinline__ static float* run(const MlpLayout& L,
                                               const void* wpack_,
                                               char* region, int tl, int bar) {
    const bf16* wpack = static_cast<const bf16*>(wpack_);
    bf16* cur = act(region, 0);
    bf16* nxt = act(region, 1);
    bf16* wbuf = act(region, 2);
    for (int l = 0; l < L.n_layers; ++l) {
      const bool last = l + 1 == L.n_layers;
      const bf16* w = wpack + L.w_off[l];
      const float* b = reinterpret_cast<const float*>(wpack + L.b_off[l]);
      float* out_f = last ? reinterpret_cast<float*>(nxt) : nullptr;
      if (L.fpad[l] == 256) {
        mma_layer<256, GP, GT, KCW>(cur, nxt, out_f, w, b, L.k[l], wbuf, tl,
                                    bar);
      } else {
        mma_layer<128, GP, GT, KCW>(cur, nxt, out_f, w, b, L.k[l], wbuf, tl,
                                    bar);
      }
      bf16* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    group_sync(bar, GT);
    return reinterpret_cast<float*>(cur);
  }
};

// The production configurations, one group per block: f32 on 64 pixels
// with 256 threads; bf16 on 128 pixels with 512 threads, so that each pass
// of the weights through shared memory serves twice the pixels.  And the
// two-chain ones of the fused kernel's `pipe` diagnostic: two groups, each
// on half the pixels with half the threads (their weight chunks are halved
// so both groups fit).
using F32Full = F32Stage<P, NT, KC>;
using F32Pipe = F32Stage<P / 2, NT / 2, KC / 2>;
using Bf16Full = Bf16Stage<2 * P, 2 * NT>;
using Bf16Pipe = Bf16Stage<P, NT, KCB / 2>;

}  // namespace
