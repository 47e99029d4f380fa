// Tiled PSF MLP for Hopper (sm_90a): a flat field [N, 4] = (x, y, z, foc_z)
// -> [N, f] PSF rows, f = ks * ks = 121: the 11 dense layers
// 4->64->256->8x256->121 with ReLU after the first 10, then sigmoid, then
// division by the row's L1 sum + 1e-12.  It is the first stage of the
// two-stage render (ops/render.py:local_psf_render is the second), taken
// for frames whose size is not the PSF surrogate's sensor resolution.
//
// Replaces the Pallas TPU kernel `_kernel` of aadff_tpu/ops/pallas_mlp.py
// (:40-57) as launched by `mlp_psf_pallas` (:62-116, pallas_call at :100),
// in both of its compute dtypes: f32 (the default) and bf16 (weights cast
// once, :83; every layer's input cast, :51; f32 accumulation).  The TPU
// kernel pads N up to its 1024-row tile; this one takes any N and masks the
// ragged end.
//
// What bounds it on an H100.  A row costs 571,904 multiply-adds, and reads
// 16 bytes and writes 484, so at the main configuration's N = 2 x 480 x 640
// = 614,400 rows it is 702.8 GFLOP against 307 MB: 10.49 ms in f32 on the
// CUDA cores (67 TFLOP/s), 0.71 ms in bf16 on the tensor cores (989
// TFLOP/s), and 0.09 ms of memory traffic at 3.35 TB/s.  It is bound by
// operations.
//
// What this design does about it.  Only the field rows and the PSF rows
// touch device memory: one block owns consecutive rows and runs the whole
// MLP on them on the SM (mlp_tile.cuh, the same stages as the fused render
// kernel).
//  * f32: 64 rows, 256 threads, FMA on the CUDA cores.  The normalised rows
//    are written row-major [64, f] into the free activation buffer.
//  * bf16: 128 rows, three warpgroups (wg::): two consumers of 64 rows take
//    turns running wgmma with activations in registers, a producer streams
//    the weight chunks with bulk copies into an 8-stage mbarrier ring.  The
//    sigmoid and L1 norm run on the accumulators; each consumer leaves its
//    rows [64, f] in shared memory and stores them itself.  What we think
//    holds it at about half of its bound is the same as for the fused
//    kernel (not measured): the weights each SM takes in per 128 rows, and
//    the epilogues that the turns do not hide.
// Either way a block's output is one contiguous run of rows * f floats in
// device memory, stored with consecutive threads on consecutive addresses.
// Rows past N are zero and never stored.

#include "mlp_tile.cuh"

namespace {

// One group of Stage::GT threads on Stage::GP rows a block.
template <class Stage>
__global__ void __launch_bounds__(Stage::GT, 1)
mlp_psf_kernel(const float* __restrict__ field,
               const void* __restrict__ wpack,
               const __grid_constant__ MlpLayout L, float* __restrict__ out,
               int N) {
  constexpr int GP = Stage::GP;
  extern __shared__ float4 smem4[];
  char* region = reinterpret_cast<char*>(smem4);

  const int t = threadIdx.x;
  const int row0 = blockIdx.x * GP;
  const int rows = min(GP, N - row0);
  const int taps = L.f[L.n_layers - 1];

  // one field row per thread; rows past N are zero and never stored
  if (t < GP) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < rows) v = reinterpret_cast<const float4*>(field)[row0 + t];
    Stage::put_field(region, t, v.x, v.y, v.z, v.w);
  }
  __syncthreads();
  const float* res = Stage::run(L, wpack, region, t, 1);

  // Row-major [GP, taps] into the other activation buffer.
  float* rowbuf = Stage::spare(region, L.n_layers);
  if (t < GP) {
    sigmoid_l1_px(res + t * Stage::PSTR, Stage::FSTR, rowbuf + t * taps, 1,
                  taps);
  }
  __syncthreads();

  float* dst = out + (size_t)row0 * taps;
  for (int i = t; i < rows * taps; i += Stage::GT) dst[i] = rowbuf[i];
}

template <class Stage>
int launch(const float* field, const void* wpack, const MlpLayout& L,
           float* out, int N, cudaStream_t stream) {
  const size_t smem = Stage::kBytes;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_psf_kernel<Stage>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((N + Stage::GP - 1) / Stage::GP);
  mlp_psf_kernel<Stage><<<blocks, Stage::GT, smem, stream>>>(field, wpack, L,
                                                             out, N);
  return (int)cudaGetLastError();
}

// The bf16 kernel (mlp_tile.cuh, wg::): 128 rows a block, consumer c on
// rows 64c .. 64c+63.
__global__ void __launch_bounds__(wg::kThreads, 1)
mlp_psf_wg(const float* __restrict__ field, const void* __restrict__ wpack,
           const __grid_constant__ MlpLayout L, float* __restrict__ out,
           int N, int nchunks, int nbias) {
  extern __shared__ __align__(1024) char smem_raw[];
  char* sm = wg::aligned_smem(smem_raw);
  const int taps = L.f[L.n_layers - 1];
  const wg::Smem m = wg::smem_plan(nbias, taps, 0, 0);
  const wg::Ring ring = wg::ring_init(sm, m);
  const int t = threadIdx.x;

  if (t >= 256) {  // the producer warpgroup
    wg::setmaxnreg_dec<wg::kProducerRegs>();
    if (t == 256) {
      const bf16* w = static_cast<const bf16*>(wpack) + L.w_off[0];
      wg::produce(ring, reinterpret_cast<const char*>(w), nchunks, 1);
    }
  } else {  // the two consumer warpgroups
    wg::setmaxnreg_inc<wg::kConsumerRegs>();
    float* bias = reinterpret_cast<float*>(sm + m.bias);
    const float* gbias = reinterpret_cast<const float*>(
        static_cast<const bf16*>(wpack) + L.b_off[0]);
    for (int i = t; i < nbias; i += 256) bias[i] = gbias[i];
    group_sync(wg::kBarConsumers, 256);

    const int c = t >> 7;  // consumer
    const int tw = t & 127;
    const long long row0 = (long long)blockIdx.x * wg::kPixels + 64 * c;
    const int row = 16 * (tw >> 5) + ((tw & 31) >> 2);
    float fld[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = row0 + row + 8 * h;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < N) v = reinterpret_cast<const float4*>(field)[r];
      fld[h][0] = v.x;
      fld[h][1] = v.y;
      fld[h][2] = v.z;
      fld[h][3] = v.w;
    }
    float* psf =
        reinterpret_cast<float*>(sm + m.psf) + c * wg::psf_floats(taps);
    wg::Pos pos;
    wg::Turn turn(c);
    wg::run_mlp(L, ring, pos, turn, bias, fld[0], fld[1], psf, taps, tw);
    group_sync(2 + c, 128);
    const long long left = (long long)N - row0;
    const int rows = left <= 0 ? 0 : (left < 64 ? (int)left : 64);
    float* dst = out + row0 * taps;
    for (int i = tw; i < rows * taps; i += 128) dst[i] = psf[i];
    turn.finish();
  }
}

int launch_wg(const float* field, const void* wpack, const MlpLayout& L,
              float* out, int N, int nchunks, int nbias,
              cudaStream_t stream) {
  const wg::Smem m = wg::smem_plan(nbias, L.f[L.n_layers - 1], 0, 0);
  const dim3 grid((N + wg::kPixels - 1) / wg::kPixels);
  return wg::launch(mlp_psf_wg, grid, (size_t)m.total, stream, field, wpack,
                    L, out, N, nchunks, nbias);
}

}  // namespace

extern "C" {

// field [N, 4], out [N, f_last]: f32, contiguous, on the current device.
// wpack: the packed weights, f32 or bf16 (`use_bf16` 0 or 1); layout: host
// array of 5 ints per layer (k, f, fpad, w_off, b_off), as for
// aadff_fused_psf_render.  Launches on `stream` and returns its error (0 on
// success); it does not synchronise.
int aadff_mlp_psf(const float* field, const void* wpack, const int* layout,
                  int n_layers, float* out, int N, int use_bf16,
                  void* stream) {
  if (N < 1 || (use_bf16 != 0 && use_bf16 != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  MlpLayout L;
  if (use_bf16) {
    int nchunks = 0, nbias = 0;
    const int rc = wg::parse_wg_layout(layout, n_layers, &L, &nchunks, &nbias);
    if (rc != 0) return rc;
    return launch_wg(field, wpack, L, out, N, nchunks, nbias, st);
  }
  const int rc = parse_layout(layout, n_layers, 4, &L);
  if (rc != 0) return rc;
  // the row-major rows must fit the spare activation buffer
  if (L.f[n_layers - 1] > FMAX) return (int)cudaErrorInvalidValue;
  return launch<F32Full>(field, wpack, L, out, N, st);
}

}  // extern "C"
