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
// touch device memory: one block owns GP consecutive rows (64 in f32, 128
// in bf16) and runs the whole MLP on them in shared memory (mlp_tile.cuh,
// the same stages as the fused render kernel: f32 FMA, or bf16 mma.sync
// with f32 accumulation).  The normalised rows are written back row-major
// [GP, f] into the free activation buffer, so that the block's output, one
// contiguous run of GP * f floats in device memory, is stored with
// consecutive threads on consecutive addresses.  Each block streams all the
// weights once for its rows; in bf16 that L2 traffic, not the tensor cores,
// is the limit.

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

}  // namespace

extern "C" {

// field [N, 4], out [N, f_last]: f32, contiguous, on the current device.
// wpack: the packed weights, f32 or bf16 (`use_bf16` 0 or 1); layout: host
// array of 5 ints per layer (k, f, fpad, w_off, b_off), as for
// aadff_fused_psf_render.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
int aadff_mlp_psf(const float* field, const void* wpack, const int* layout,
                  int n_layers, float* out, int N, int use_bf16,
                  void* stream) {
  if (N < 1 || (use_bf16 != 0 && use_bf16 != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  MlpLayout L;
  const int rc = parse_layout(layout, n_layers, use_bf16 ? 8 : 4, &L);
  if (rc != 0) return rc;
  // the row-major rows must fit the spare activation buffer
  if (L.f[n_layers - 1] > (use_bf16 ? AS / 2 : FMAX) ||
      (use_bf16 && L.fpad[n_layers - 1] != 128)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  if (use_bf16) return launch<Bf16Full>(field, wpack, L, out, N, st);
  return launch<F32Full>(field, wpack, L, out, N, st);
}

}  // extern "C"
