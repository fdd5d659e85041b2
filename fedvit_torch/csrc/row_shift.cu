// Row and column shifts with zero fill (K7): the geometry of the train
// augment's rotation and of RandAugment's shear, translate and rotate.
//
// Replaces the TPU kernels fedvit_tpu/ops/row_shift.py::_row_shift_kernel and
// _col_shift_kernel (launched by _shift_call through pl.pallas_call, via
// row_shift and col_shift). Same function, on fp32 NHWC (B, H, W, C):
//
//   rows:    out[b, y, x, c] = img[b, y, x + s[b, y], c]
//   columns: out[b, y, x, c] = img[b, y + s[b, x], x, c]
//
// and 0 where the source falls outside [0, W) or [0, H). The shifts s are
// int32, (B, H) for rows and (B, W) for columns, already rounded half to even
// and clipped to +-extent by the caller (ops/row_shift.py::_shift_amount).
// Nothing is computed: the output is the plain version's, bit for bit.
//
// The TPU kernel decomposes each shift into ~log2(2W) static rolls of a
// VMEM-resident sample, because gathers are slow there. A Hopper thread can
// load from any address, so here each thread reads its one source element:
// one block row of the grid per image row (b, y), one thread per float of the
// row's W*C. In a row shift the row's floats come from one contiguous span
// moved by s*C, so a warp's loads stay coalesced; in a column shift
// neighbouring pixels read rows y + s[x] that change only where s changes.
//
// Bound on an H100 SXM: bytes, the image read once and the output written
// once. The train augment's rotation of a ViT-B/16@224 macro batch of 128
// (128, 372, 372, 4) moves 2 x 283 MB: 0.169 ms at 3.35 TB/s; RandAugment's
// (128, 250, 250, 3) 2 x 96 MB: 0.057 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

template <bool kRows>
__global__ void __launch_bounds__(kThreads)
shift_kernel(const float* __restrict__ img, const int* __restrict__ shift,
             float* __restrict__ out, int b, int h, int w, int c) {
  const int wc = w * c;
  const int i = blockIdx.x * kThreads + threadIdx.x;  // float of the row
  if (i >= wc) return;
  const int x = i / c;
  const int64_t rows = static_cast<int64_t>(b) * h;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {  // r = b * H + y
    float v = 0.f;
    if constexpr (kRows) {
      const int s = __ldg(shift + r);
      const int xs = x + s;
      if (xs >= 0 && xs < w) v = __ldg(img + r * wc + i + s * c);
    } else {
      const int64_t bi = r / h;
      const int y = static_cast<int>(r - bi * h);
      const int s = __ldg(shift + bi * w + x);
      const int ys = y + s;
      if (ys >= 0 && ys < h) v = __ldg(img + (bi * h + ys) * wc + i);
    }
    out[r * wc + i] = v;
  }
}

}  // namespace

// axis 0: shift each row along W by shift[b, y]; axis 1: shift each column
// along H by shift[b, x]. img and out are contiguous fp32 (b, h, w, c), shift
// contiguous int32. Returns a cudaError_t (0 on success); the caller checks
// devices, types, shapes and contiguity.
extern "C" int shift_fwd(const void* img, const void* shift, void* out, int b,
                         int h, int w, int c, int axis, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0 || (axis != 0 && axis != 1) ||
      static_cast<int64_t>(w) * c > (int64_t{1} << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = static_cast<int64_t>(b) * h;
  const dim3 grid((w * c + kThreads - 1) / kThreads,
                  static_cast<unsigned>(rows < kMaxGridY ? rows : kMaxGridY));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* in = static_cast<const float*>(img);
  const int* sh = static_cast<const int*>(shift);
  float* o = static_cast<float*>(out);
  if (axis == 0)
    shift_kernel<true><<<grid, kThreads, 0, s>>>(in, sh, o, b, h, w, c);
  else
    shift_kernel<false><<<grid, kThreads, 0, s>>>(in, sh, o, b, h, w, c);
  return static_cast<int>(cudaGetLastError());
}
