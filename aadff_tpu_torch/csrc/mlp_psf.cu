// Tiled PSF MLP for Hopper (sm_90a): a flat field [N, 4] = (x, y, z, foc_z)
// -> [N, f] PSF rows, f = ks * ks = 121: the 11 dense layers
// 4->64->256->8x256->121 with ReLU after the first 10, then sigmoid, then
// division by the row's L1 sum + 1e-12.  It is the first stage of the
// two-stage render (ops/render.py:local_psf_render is the second), taken
// for frames whose size is not the PSF surrogate's sensor resolution.
//
// Replaces the Pallas TPU kernel `_kernel` of aadff_tpu/ops/pallas_mlp.py
// (:40-55) as launched by `mlp_psf_pallas` (:62-116, pallas_call at :100).
// The TPU kernel pads N up to its 1024-row tile; this one takes any N and
// masks the ragged end.  It runs in f32 (the TPU kernel's bf16
// compute_dtype is not ported yet).
//
// What bounds it on an H100.  A row costs 571,904 multiply-adds, and reads
// 16 bytes and writes 484, so at the main configuration's N = 2 x 480 x 640
// = 614,400 rows it is 702.8 GFLOP against 307 MB: 10.49 ms in f32 on the
// CUDA cores (67 TFLOP/s) and 0.09 ms of memory traffic at 3.35 TB/s.  It is
// bound by operations (1.42 ms in TF32 on the tensor cores).
//
// What this first design does about it.  Only the field rows and the PSF
// rows touch device memory: one block owns P = 64 consecutive rows and runs
// the whole MLP on them in shared memory (mlp_tile.cuh, the same stage as
// the fused render kernel).  The normalised rows are written back
// transposed into the free activation buffer, row-major [64, f], so that
// the block's output, one contiguous run of 64 * f floats in device memory,
// is stored with consecutive threads on consecutive addresses.

#include "mlp_tile.cuh"

namespace {

__global__ void __launch_bounds__(NT, 1)
mlp_psf_kernel(const float* __restrict__ field,
               const float* __restrict__ wpack, MlpLayout L,
               float* __restrict__ out, int N) {
  extern __shared__ float4 smem4[];
  float* act0 = reinterpret_cast<float*>(smem4);
  float* act1 = act0 + FMAX * P;
  float* wbuf = act1 + FMAX * P;

  const int t = threadIdx.x;
  const int row0 = blockIdx.x * P;
  const int rows = min(P, N - row0);
  const int taps = L.f[L.n_layers - 1];

  // field rows -> feature-major act0[f * P + p]; rows past N are zero and
  // never stored.
  for (int i = t; i < 4 * P; i += NT) {
    const int p = i >> 2;
    const int f = i & 3;
    act0[f * P + p] = p < rows ? field[((size_t)row0 + p) * 4 + f] : 0.f;
  }
  float* cur = mlp_forward(L, wpack, act0, act1, wbuf);

  // Row-major [P, taps] into the other activation buffer.
  float* rowbuf = cur == act0 ? act1 : act0;
  sigmoid_l1(cur, rowbuf, taps, taps, 1);
  __syncthreads();

  float* dst = out + (size_t)row0 * taps;
  for (int i = t; i < rows * taps; i += NT) dst[i] = rowbuf[i];
}

}  // namespace

extern "C" {

// field [N, 4], out [N, f_last]: f32, contiguous, on the current device.
// layout: host array of 5 ints per layer (k, f, fpad, w_off, b_off), as for
// aadff_fused_psf_render.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
int aadff_mlp_psf(const float* field, const float* wpack, const int* layout,
                  int n_layers, float* out, int N, void* stream) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  MlpLayout L;
  const int rc = parse_layout(layout, n_layers, &L);
  if (rc != 0) return rc;

  const size_t smem = sizeof(float) * (size_t)MLP_SMEM_FLOATS;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_psf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;

  const unsigned blocks = (unsigned)((N + P - 1) / P);
  mlp_psf_kernel<<<blocks, NT, smem, (cudaStream_t)stream>>>(field, wpack, L,
                                                             out, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
