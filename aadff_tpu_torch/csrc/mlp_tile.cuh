// The PSF MLP on a tile of pixels, shared by the two kernels that run it:
// fused_psf_render.cu (MLP -> per-pixel convolution in one launch) and
// mlp_psf.cu (MLP -> [N, 121] PSF rows in device memory).  Two designs
// compute the same 11 layers, one per compute dtype.
//
// f32 (F32Stage, mlp_layer): plain f32 FMA on the CUDA cores.  Activations
// are feature-major, act[f * GP + p], and ping-pong between two [FMAX x GP]
// f32 buffers in shared memory.  Each layer is a small GEMM out[f,p] =
// sum_k W^T[k,f] * in[k,p]: every thread keeps an (8 features x 8 pixels)
// tile of sums in registers, so a k step is four 16-byte shared loads for
// 64 FMAs.  Weights are read through L2 in chunks of KC rows, staged into
// shared memory with cp.async and double-buffered.  A stage runs on a
// *group* of GT threads that owns GP pixels, with its own buffers and named
// barrier: one group of 256 threads on 64 pixels a block, or, for the
// fused kernel's `pipe` diagnostic, two groups on half the pixels each.
//
// bf16 (namespace wg): the TPU kernel's compute_dtype=bf16 (pallas_render.py
// :137-150, pallas_mlp.py:40-57) with wgmma on Hopper's tensor cores.  Every
// layer's input is rounded to bf16 (round to nearest even), the field
// included; weights are rounded once by the wrapper; products are summed in
// f32, then the f32 bias and ReLU; the last layer's pre-activation stays
// f32 for the sigmoid and the L1 norm.
//
// What bounds it.  571,904 multiply-adds a pixel: 0.36 ms a 480x640 frame
// at the H100's 989 TFLOP/s dense bf16, ~36k cycles of tensor-core work
// per 128-pixel tile and frame.  Every block must also bring all 1.14 MB
// of bf16 weights from L2 into shared memory per tile and frame: at the
// MMA's peak that is ~32 bytes a cycle into every SM.  If an SM cannot take
// in much more than that from L2 (a guess: its intake rate has not been
// measured), the weight stream and the tensor cores are twin limits.  What
// costs time besides: re-reading activation fragments
// from shared memory, threads spent on copies and block-wide barriers per
// chunk, and epilogues during which the tensor cores idle.
//
// The design.  A block (kThreads = 384) is three warpgroups on a tile of
// kPixels = 128 pixels:
//  * Two consumer warpgroups, each owning 64 pixels and running the whole
//    chain on them: wgmma.mma_async m64n{64,128}k16 f32.bf16.bf16 with A
//    from registers and B, the weight chunk, from shared memory through a
//    descriptor.  A layer's m64n128 accumulator (64 f32 a thread) has the
//    layout of the next layer's A fragments, so bias, ReLU and the bf16
//    cast turn it into A in registers (FlashAttention-3's P): activations
//    are never re-read.  A 256-wide layer runs as two output halves; the
//    first half's fragments wait in shared memory (a 16 KB stash) while
//    the second half's wgmma still reads the input, so only the 64 input
//    fragments and one accumulator are live.  ptxas compiles every role
//    within the 168 registers a thread of a 384-thread block gets at
//    launch (with three consumers, 128 at launch, it spills), and the
//    stash keeps the consumers within that without spills; setmaxnreg
//    then moves registers from the producer (40) to the consumers (232).
//  * The consumers take turns on the tensor cores (ping-pong, on named
//    barriers): one issues a GEMM's wgmmas, passes the turn, and runs its
//    epilogue while the other's wgmmas execute.
//  * One producer warpgroup, of which one thread streams the weights:
//    16 KB chunks (128 output rows x 64 k) into a ring of kStages = 8
//    stages with cp.async.bulk (the 1-D TMA copy, no tensor map), each
//    completing on the stage's `full` mbarrier; consumer warps release a
//    stage on its `empty` mbarrier as soon as their wgmma group on it has
//    completed.  No block-wide barrier is left in the loop.
//  * pack_mlp_weights(mlp, bf16) stores each chunk as the exact image the
//    descriptor reads: rows of 128 bytes (64 k, k contiguous: K-major), the
//    16-byte groups of row r XOR-swizzled by r % 8 (the 128-byte swizzle),
//    so one copy lands it ready.  Layer 0 (K = 4, zero-padded to 16, one
//    MMA step) has one chunk whose rows 64-127 are zero; the last layer's
//    121 outputs are zero-padded to 128.  Layer widths are therefore
//    4(16) -> 64, 64 -> 256, n x 256 -> 256, 256 -> 121(128).
//  * Every block reads every chunk from L2 itself.  Clusters of 2 or 4
//    blocks that multicast each chunk to all of them were measured slower
//    on the H100 (2: 1.4-3.7%, 4: 8-12%; PERF.md, section 6): they halve
//    the bytes read from L2 but not the bytes each SM takes in.
//  * The sigmoid and the L1 norm run on the accumulators in registers (a
//    row's sum is reduced over the 4 lanes of a quad), and write the
//    normalised rows [64, taps] f32 into shared memory for the caller's
//    epilogue (the convolution, or the rows' store), which runs on the
//    consumer's own 128 threads.
// The two consumers are the TPU kernel's `pipe` (two half-tile chains), so
// the bf16 `pipe` diagnostic launches this same kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P = 64;             // pixels per f32 block
constexpr int NT = 256;           // threads per f32 block
constexpr int KC = 32;            // f32 weight rows per staged chunk
constexpr int FMAX = 256;         // widest (padded) layer
constexpr int MAX_LAYERS = 16;
constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block may use


using bf16 = __nv_bfloat16;

// Layout of the packed weights, decided by the Python wrapper
// (ops/fused_render.py:pack_mlp_weights).  For layer l, outputs f are
// zero-padded to fpad (128 or 256), and w_off / b_off count elements of the
// buffer's type:
//   f32:  W^T [k, fpad] at w_off, bias [fpad] f32 at b_off;
//   bf16: the layer's weight chunks from w_off on (see wg:: below), the
//         chunks of all layers first, in the order the stage reads them,
//         then every layer's bias [fpad] f32 (two bf16 slots per float).
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

// ------------------------------------------------------ bf16 (wgmma) ----
//
// A block of the bf16 stage is three warpgroups: two consumers, each owning
// 64 of the tile's 128 pixels, and one producer.  See the note at the top of
// this file.

namespace wg {

constexpr int kThreads = 384;       // consumers: threads 0-255; producer 256+
constexpr int kPixels = 128;        // pixels of a tile, 64 per consumer
constexpr int kChunkBytes = 16384;  // one weight chunk: 128 rows x 64 k bf16
constexpr int kChunkElems = kChunkBytes / 2;
constexpr int kStages = 8;          // chunks in flight in the ring
constexpr int kBarConsumers = 1;    // named barrier of both consumers
// consumer c (0 or 1) synchronises its own 128 threads on barrier 2 + c,
// and waits for its turn on the tensor cores on barrier 4 + c
constexpr long long kHangCycles = 1LL << 35;  // ~19 s: a lost chunk traps

// Chunks of layer l: (fpad / 128) output halves x ceil(k / 64) k-chunks.
__host__ __device__ inline int layer_chunks(const MlpLayout& L, int l) {
  return (L.fpad[l] / 128) * ((L.k[l] + 63) / 64);
}

// The bf16 stage's MLP is 4 -> 64 -> 256 -> (256 ->) * n -> f <= 128, the
// PSF surrogate's shape (psfnet/arch.py): layer 0 has K = 4 (zero-padded to
// 16, one MMA step, in a 64-wide chunk row) and 64 outputs (its chunk has
// 128 rows, the last 64 zero); the last layer's outputs are padded to 128.
// The chunks of all layers are one run from w_off[0] in reading order and
// the biases one run from b_off[0].  Returns 0 or a cudaError_t code, and
// the chunk count of one pass in *nchunks and the bias floats in *nbias.
inline int parse_wg_layout(const int* layout, int n_layers, MlpLayout* L,
                           int* nchunks, int* nbias) {
  const int rc = parse_layout(layout, n_layers, 8, L);
  if (rc != 0) return rc;
  const int last = n_layers - 1;
  bool ok = n_layers >= 3 && L->f[0] == 64 && L->fpad[0] == 128 &&
            L->f[1] == 256 && L->fpad[last] == 128;
  int chunks = 0, floats = 0;
  for (int l = 0; l < n_layers; ++l) {
    if (l >= 1 && l < last) ok = ok && L->f[l] == 256;
    ok = ok && L->w_off[l] == L->w_off[0] + chunks * kChunkElems &&
         L->b_off[l] == L->b_off[0] + 2 * floats;
    chunks += layer_chunks(*L, l);
    floats += L->fpad[l];
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  *nchunks = chunks;
  *nbias = floats;
  return 0;
}

// Byte offsets of a block's shared memory from its 1024-byte-aligned base:
// the ring of weight chunks, its barriers, the biases, each consumer's
// normalised PSF rows [64, taps] f32, then `part` and `halo` floats for the
// caller.  `total` includes the slack for aligning the base.
struct Smem {
  int bars, bias, psf, part, halo, total;
};
// Floats of one consumer's psf rows, at least the 16 KB of its stash.
__host__ __device__ inline int psf_floats(int taps) {
  return 64 * taps > 4096 ? 64 * taps : 4096;
}
__host__ __device__ inline Smem smem_plan(int nbias, int taps, int part,
                                          int halo) {
  Smem m;
  m.bars = kStages * kChunkBytes;
  m.bias = m.bars + 2 * 8 * kStages;
  m.psf = m.bias + 4 * nbias;
  m.part = m.psf + 4 * 2 * psf_floats(taps);
  m.halo = m.part + 4 * part;
  m.total = m.halo + 4 * halo + 1024;
  return m;
}

// ---- PTX ------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// The phase of parity `parity` has completed.
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase; trap (an error the launch reports, not a hang) if it
// does not come within kHangCycles.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity)) {
    if (clock64() - t0 > kHangCycles) __trap();
  }
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// 1-D bulk copy (TMA without a tensor map) of `bytes` from global memory
// into this block's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kRegs));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes, so that the
// compiler neither reads an accumulator before the wait nor reuses an A
// fragment's register while the wgmma may still read it.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Descriptor of a K-major operand in shared memory in the 128-byte swizzle:
// rows of 128 bytes (64 bf16 of k), 8-row atoms 1024 bytes apart (SBO), the
// atom 1024-byte aligned.  Adding 2 steps k by 16 (32 bytes).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[0..32) = (scale_d ? d : 0) + A (registers, 64 x 16 bf16) x B
// (descriptor, 16 x 64).
__device__ __forceinline__ void wgmma_n64(float* d, uint32_t a0, uint32_t a1,
                                          uint32_t a2, uint32_t a3,
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc),
        "r"(scale_d));
}

// d[0..64) = (scale_d ? d : 0) + A (registers, 64 x 16 bf16) x B
// (descriptor, 16 x 128).
__device__ __forceinline__ void wgmma_n128(float* d, uint32_t a0, uint32_t a1,
                                          uint32_t a2, uint32_t a3,
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc),
        "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- the ring -------------------------------------------------------------

// The shared-memory ring of weight chunks: stage addresses and the two
// barrier arrays (shared addresses).  `full[s]` completes when chunk s has
// landed (the producer's arrival plus its bytes); `empty[s]` when the 8
// consumer warps are done with it.
struct Ring {
  uint32_t base, full, empty;
  __device__ uint32_t stage(int s) const { return base + s * kChunkBytes; }
};

// A role's place in the ring: the stage and the parity of its round.
struct Pos {
  int stage = 0;
  uint32_t phase = 0;
  __device__ void next() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// Set up the ring at the block's aligned base; every thread of the block
// must call it before either role starts.
__device__ __forceinline__ Ring ring_init(char* sm, const Smem& m) {
  Ring r;
  r.base = smem_addr(sm);
  r.full = r.base + m.bars;
  r.empty = r.full + 8 * kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(r.full + 8 * s, 1);
      mbar_init(r.empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The block's dynamic shared memory, aligned up to 1024 bytes (the
// 128-byte swizzle's atom).
__device__ __forceinline__ char* aligned_smem(char* raw) {
  const uint32_t a = smem_addr(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// The producer: one thread streams `frames` passes of the `nchunks` weight
// chunks at w, one bulk copy a chunk.
__device__ __forceinline__ void produce(const Ring& r, const char* w,
                                        int nchunks, int frames) {
  Pos pos;
  for (int s = 0; s < frames; ++s) {
    for (int c = 0; c < nchunks; ++c) {
      const uint32_t full = r.full + 8 * pos.stage;
      mbar_wait(r.empty + 8 * pos.stage, pos.phase ^ 1u);
      mbar_expect_tx(full, kChunkBytes);
      bulk_copy(r.stage(pos.stage), w + (size_t)c * kChunkBytes, kChunkBytes,
                full);
      pos.next();
    }
  }
}

// A consumer warp is done with stage s: its lane 0 arrives on the stage's
// empty barrier.
__device__ __forceinline__ void release(const Ring& r, int s, int lane) {
  if (lane == 0) mbar_arrive(r.empty + 8 * s);
}

// The two consumers take turns on the tensor cores (FlashAttention-3's
// ping-pong): consumer c issues a GEMM's wgmmas only once the other has
// issued its previous one, so that one consumer's epilogue (bias, ReLU,
// casts, the sigmoid, the convolution) runs while the other's wgmmas do.
// Consumer 0 goes first; every wait matches one pass of the other, and
// consumer 0's `finish` takes consumer 1's last pass.
struct Turn {
  int c;
  bool first = true;
  __device__ explicit Turn(int consumer) : c(consumer) {}
  __device__ void wait() {
    if (c == 1 || !first) {
      asm volatile("bar.sync %0, 256;" ::"r"(4 + c) : "memory");
    }
    first = false;
  }
  __device__ void pass() const {
    asm volatile("bar.arrive %0, 256;" ::"r"(5 - c) : "memory");
  }
  __device__ void finish() const {
    if (c == 0) asm volatile("bar.sync 4, 256;" ::: "memory");
  }
};

// Wait for the wgmma groups of the last N + 1 chunks in turn, releasing
// each chunk (from stage s on) as soon as its group has completed.
template <int N>
__device__ __forceinline__ void wait_release(const Ring& r, int s, int lane) {
  wgmma_wait<N>();
  release(r, s, lane);
  if constexpr (N > 0) {
    wait_release<N - 1>(r, s + 1 == kStages ? 0 : s + 1, lane);
  }
}

// acc [64 px, 128 f] = A [64 px, 64 * NK] x chunk^T over the next NK chunks
// of the ring: 4 wgmma m64n128k16 a chunk, A from registers (k-slice t in
// a[4t .. 4t+3]), one commit group a chunk, all issued in this consumer's
// turn; a chunk is released as soon as its group has completed.
template <int NK>
__device__ __forceinline__ void gemm_n128(float* acc, uint32_t* a,
                                          const Ring& r, Pos& pos, int lane,
                                          Turn& turn) {
  fence_regs<16 * NK>(a);
  turn.wait();
  wgmma_fence();
  const int s0 = pos.stage;
#pragma unroll
  for (int kc = 0; kc < NK; ++kc) {
    mbar_wait(r.full + 8 * pos.stage, pos.phase);
    const uint64_t desc = sw128_desc(r.stage(pos.stage));
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int t = 4 * kc + s;
      wgmma_n128(acc, a[4 * t], a[4 * t + 1], a[4 * t + 2], a[4 * t + 3],
                 desc + 2 * s, kc + s > 0);
    }
    wgmma_commit();
    pos.next();
  }
  turn.pass();
  wait_release<NK - 1>(r, s0, lane);
  fence_regs<64>(acc);
  fence_regs<16 * NK>(a);
}

// Bias, ReLU and the cast to bf16 of 16 * NT accumulator columns, written
// as the A fragments of the next layer's k-slices: the m64nNk16 accumulator
// and the m64k16 A fragment share their layout (row lane/4 and +8 of the
// warp's 16, columns 2 * (lane % 4) + {0, 1} and +8).
template <int NT>
__device__ __forceinline__ void relu_bf16(const float* acc, const float* bias,
                                          uint32_t* out, int q) {
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 b = *reinterpret_cast<const float2*>(
          bias + 16 * t + 8 * (e >> 1) + 2 * q);
      out[4 * t + e] = pack_bf16(fmaxf(acc[8 * t + 2 * e] + b.x, 0.f),
                                 fmaxf(acc[8 * t + 2 * e + 1] + b.y, 0.f));
    }
  }
}

// The same for an output half of 128 columns, stored to `stash` (this
// thread's 32 fragments, 16 bytes at a time, thread-interleaved) instead of
// registers: the finished first half waits there while the second half's
// wgmma still reads the layer's input fragments.
__device__ __forceinline__ void relu_bf16_stash(const float* acc,
                                                const float* bias,
                                                uint4* stash, int q, int tw) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t v[4];
    relu_bf16<1>(acc + 8 * i, bias + 16 * i, v, q);
    stash[i * 128 + tw] = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ void unstash(const uint4* stash, uint32_t* a,
                                        int tw) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint4 v = stash[i * 128 + tw];
    a[4 * i] = v.x;
    a[4 * i + 1] = v.y;
    a[4 * i + 2] = v.z;
    a[4 * i + 3] = v.w;
  }
}

// The whole MLP on one consumer's 64 pixels, then the sigmoid and the L1
// normalisation: psf [64, taps] f32 in shared memory (row p at p * taps,
// at least 16 KB, 16-byte aligned).
// Thread tw (0..127) brings the field (x, y, z, foc_z) of its pixels
// 16 * (tw / 32) + lane / 4 (lo) and that + 8 (hi).  The next `nchunks` of
// the ring are consumed in the packed order.
__device__ __forceinline__ void run_mlp(const MlpLayout& L, const Ring& r,
                                        Pos& pos, Turn& turn,
                                        const float* bias, const float* lo,
                                        const float* hi, float* psf, int taps,
                                        int tw) {
  const int lane = tw & 31;
  const int q = lane & 3;
  const int row = 16 * (tw >> 5) + (lane >> 2);
  float acc[64];

  // layer 0: K = 4 zero-padded to 16 (k 0-1 in lane q = 0, k 2-3 in q = 1)
  uint32_t a0[4];
  a0[0] = q == 0 ? pack_bf16(lo[0], lo[1]) : q == 1 ? pack_bf16(lo[2], lo[3])
                                                     : 0u;
  a0[1] = q == 0 ? pack_bf16(hi[0], hi[1]) : q == 1 ? pack_bf16(hi[2], hi[3])
                                                     : 0u;
  a0[2] = 0u;
  a0[3] = 0u;
  fence_regs<4>(a0);
  turn.wait();
  wgmma_fence();
  mbar_wait(r.full + 8 * pos.stage, pos.phase);
  wgmma_n64(acc, a0[0], a0[1], a0[2], a0[3], sw128_desc(r.stage(pos.stage)),
            0);
  wgmma_commit();
  turn.pass();
  wgmma_wait<0>();
  fence_regs<32>(acc);
  fence_regs<4>(a0);
  release(r, pos.stage, lane);
  pos.next();
  uint32_t a1[16];
  relu_bf16<4>(acc, bias, a1, q);
  bias += L.fpad[0];

  // layer 1: 64 -> 256, two output halves of one chunk each; each layer's
  // first half waits in `stash` (this consumer's psf rows, free until the
  // last layer) so that only the input fragments and one accumulator are
  // ever live
  uint4* stash = reinterpret_cast<uint4*>(psf);
  uint32_t ah[64];
  gemm_n128<1>(acc, a1, r, pos, lane, turn);
  relu_bf16_stash(acc, bias, stash, q, tw);
  gemm_n128<1>(acc, a1, r, pos, lane, turn);
  relu_bf16<8>(acc, bias + 128, ah + 32, q);
  unstash(stash, ah, tw);
  bias += L.fpad[1];

  // hidden layers 256 -> 256: the second half's output overwrites the
  // input fragments once its wgmma has completed
  for (int l = 2; l + 1 < L.n_layers; ++l) {
    gemm_n128<4>(acc, ah, r, pos, lane, turn);
    relu_bf16_stash(acc, bias, stash, q, tw);
    gemm_n128<4>(acc, ah, r, pos, lane, turn);
    relu_bf16<8>(acc, bias + 128, ah + 32, q);
    unstash(stash, ah, tw);
    bias += L.fpad[l];
  }

  // last layer: f32 pre-activation, sigmoid, L1 over the taps of each row
  // (the 4 lanes of a quad hold a row's columns)
  gemm_n128<4>(acc, ah, r, pos, lane, turn);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * q + (e & 1);
      const float v = 1.f / (1.f + expf(-(acc[4 * j + e] + bias[col])));
      acc[4 * j + e] = v;
      if (col < taps) sum[e >> 1] += fabsf(v);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    sum[h] += 1e-12f;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * q + (e & 1);
      if (col < taps) {
        psf[(row + 8 * (e >> 1)) * taps + col] = acc[4 * j + e] / sum[e >> 1];
      }
    }
  }
}

// Launch `kernel` with kThreads threads a block.  Returns the launch's
// error.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
           Args... args) {
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidConfiguration;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Registers of the roles after setmaxnreg: 2 x 128 x 232 + 128 x 40 =
// 65,536 - 1,024, within the 168 a thread that __launch_bounds__(384, 1)
// gives every thread at launch.
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;

}  // namespace wg

// The f32 production configuration, one group per block: 64 pixels with
// 256 threads.  And the two-chain one of the fused kernel's `pipe`
// diagnostic: two groups, each on half the pixels with half the threads
// (their weight chunks are halved so both groups fit).
using F32Full = F32Stage<P, NT, KC>;
using F32Pipe = F32Stage<P / 2, NT / 2, KC / 2>;

}  // namespace
