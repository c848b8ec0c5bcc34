// kernel-launch fixture: shared-memory budgets of a Hopper block
constexpr int kRows = 128;
constexpr int kBig = 1 << 15;

__global__ void fits(float* out) {
  __shared__ float tile[kRows][32];          // 16 KB: fits
  out[0] = tile[0][0];
}

__global__ void too_big(float* out) {
  __shared__ float tile[kBig][2];            // 256 KB static: over 48 KB
  extern __shared__ float dyn[];             // sized at launch: skipped
  out[0] = tile[0][0] + dyn[0];
}

void launch(float* out) {
  cudaFuncSetAttribute(fits, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       300 * 1024);
  too_big<<<1, 32, 64 * 1024>>>(out);
  // tracelint: allow[kernel-launch] -- a fixture of the inline allow in CUDA
  too_big<<<1, 32, 256 * 1024>>>(out);
}
