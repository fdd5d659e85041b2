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
// load from any address, so here each output element reads its one source
// element, and the work is to keep enough bytes in flight:
//
//   - The output is cut into groups of 4 consecutive floats, 16-byte
//     aligned, whatever the rows and pixels. A thread takes kGroups groups
//     kThreads groups apart (a warp's stores are 512 contiguous bytes): it
//     finds every group's row and loads its shifts, then issues every
//     group's loads, then stores them as float4, so one shift latency
//     precedes loads that are all in flight together.
//   - A group inside one row reads a contiguous source: shifted by s*C floats
//     (rows), or by s rows where its pixels share one shift (columns; always
//     at C = 4, where a group is a pixel). An aligned source is one float4
//     load; a misaligned one (C = 3 rows at 3 s mod 4 != 0, a view at an odd
//     storage offset) is the two aligned float4 around it, shifted in
//     registers. The source's zero-filled ends and a column group whose
//     pixels differ in shift take a scalar load an element; so does a window
//     that would leave the image, which keeps every load inside it, and a
//     group across two rows, which also loads its shifts itself.
//   - C is a template parameter (1, 3 and 4; 0 reads it at run time). Below
//     2^31 floats the flat index is 32-bit and split into (row, float of the
//     row) and (sample, image row) by a multiply-high and a shift, never a
//     division; above, the same kernel indexes in 64 bits.
//
// Bound on an H100 SXM: bytes, the image read once, the output written once
// and the shifts read once. The train augment's rotation of a ViT-B/16@224
// macro batch of 128 (128, 372, 372, 4) moves 2 x 283 MB: 0.169 ms at
// 3.35 TB/s; RandAugment's (128, 250, 250, 3) 2 x 96 MB: 0.057 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 2;                   // 4-float groups a thread
constexpr int kTile = 4 * kThreads * kGroups;  // floats a block

// n / d. For 32-bit indices (n < 2^31): q = umulhi(n, m) >> s with
// m = ceil(2^(31 + l) / d), l = ceil(log2 d), exact for every n < 2^31
// (Granlund and Montgomery); 64-bit indices divide.
template <typename I>
struct Divider {
  I d;
  __host__ explicit Divider(I div) : d(div) {}
  __device__ I div(I n) const { return n / d; }
};

template <>
struct Divider<uint32_t> {
  uint32_t d, m, s;
  __host__ explicit Divider(uint32_t div) : d(div), m(0), s(0) {
    uint32_t l = 0;
    while ((uint64_t{1} << l) < div) ++l;
    if (l > 0) {
      m = static_cast<uint32_t>(((uint64_t{1} << (31 + l)) + div - 1) / div);
      s = l - 1;
    }
  }
  __device__ uint32_t div(uint32_t n) const {
    return d == 1 ? n : __umulhi(n, m) >> s;
  }
};

template <typename I>
struct Shift {
  const float* img;
  const int* shift;
  float* out;
  I n;                 // floats of the image
  int h, w, c;
  int wc;              // floats a row
  Divider<I> by_row;    // flat index -> (row b * H + y, float of the row)
  Divider<I> by_h;      // row -> (b, y)
  bool out_vec;        // out is 16-byte aligned
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// src[0..3] into e, all four inside [lo, hi): one aligned float4 load, or the
// two aligned float4 around a misaligned src where both lie inside [lo, hi),
// else four scalar loads
__device__ __forceinline__ void load4(float (&e)[4], const float* src,
                                      const float* lo, const float* hi) {
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(src) >> 2) & 3;
  float4 v;
  if (off == 0) {
    v = ld4(src);
  } else if (src - off >= lo && src - off + 8 <= hi) {
    const float4 x = ld4(src - off), y = ld4(src - off + 4);
    v = off == 1 ? make_float4(x.y, x.z, x.w, y.x)
        : off == 2 ? make_float4(x.z, x.w, y.x, y.y)
                   : make_float4(x.w, y.x, y.y, y.z);
  } else {
    v = make_float4(__ldg(src), __ldg(src + 1), __ldg(src + 2), __ldg(src + 3));
  }
  e[0] = v.x; e[1] = v.y; e[2] = v.z; e[3] = v.w;
}

// Group g of a thread is the 4 output floats at f = first + 4 kThreads g.
// The thread finds every group's row and loads its shifts, then issues every
// group's loads, then stores: one shift latency a thread, and the data loads
// of all groups in flight together.
template <bool kRows, int C, typename I>
__global__ void __launch_bounds__(kThreads) shift_kernel(const Shift<I> p) {
  // pixels a group of one row touches (columns): C = 1 four, C = 4 one, else
  // at most two
  constexpr int kPix = kRows ? 1 : C == 1 ? 4 : C == 4 ? 1 : 2;
  const int c = C ? C : p.c;
  const I first = static_cast<I>(blockIdx.x) * kTile + 4 * threadIdx.x;
  I row[kGroups];
  int col[kGroups], y[kGroups], s[kGroups][kPix];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const I f = first + static_cast<I>(4 * kThreads * g);
    row[g] = p.by_row.div(f < p.n ? f : 0);
    col[g] = static_cast<int>((f < p.n ? f : 0) - row[g] * p.wc);
    y[g] = 0;
    if constexpr (kRows) {
      s[g][0] = f < p.n ? __ldg(p.shift + row[g]) : 0;
    } else {
      const I b = p.by_h.div(row[g]);
      y[g] = static_cast<int>(row[g] - b * p.h);
      const int x0 = col[g] / c;
#pragma unroll
      for (int q = 0; q < kPix; ++q)
        s[g][q] = f < p.n ? __ldg(p.shift + static_cast<long long>(b) * p.w +
                                  min(x0 + q, p.w - 1))
                          : 0;
    }
  }
  float e[kGroups][4];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const I f = first + static_cast<I>(4 * kThreads * g);
#pragma unroll
    for (int k = 0; k < 4; ++k) e[g][k] = 0.f;
    if (f >= p.n) continue;
    const float* src = p.img + static_cast<long long>(f);
    const float* end = p.img + p.n;
    if (col[g] + 4 > p.wc) {
      // across two rows (or more, at W C < 4): a shift load and a load an
      // element
      I r = row[g];
      int ik = col[g];
#pragma unroll
      for (int k = 0; k < 4; ++k, ++ik) {
        if (f + k >= p.n) break;
        while (ik >= p.wc) { ik -= p.wc; ++r; }
        if constexpr (kRows) {
          const long long from = ik + static_cast<long long>(__ldg(p.shift + r)) * c;
          if (from >= 0 && from < p.wc)
            e[g][k] = __ldg(p.img + (static_cast<long long>(r) * p.wc + from));
        } else {
          const I b = p.by_h.div(r);
          const int yk = static_cast<int>(r - b * p.h);
          const int sk = __ldg(p.shift + static_cast<long long>(b) * p.w + ik / c);
          if (yk + sk >= 0 && yk + sk < p.h)
            e[g][k] = __ldg(p.img + ((static_cast<long long>(r) + sk) * p.wc + ik));
        }
      }
    } else if constexpr (kRows) {
      // one row: the source is the row moved by s c floats, zero where it
      // leaves the row
      const long long d = static_cast<long long>(s[g][0]) * c, at = col[g] + d;
      if (at >= 0 && at + 4 <= p.wc) {
        load4(e[g], src + d, p.img, end);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (at + k >= 0 && at + k < p.wc) e[g][k] = __ldg(src + d + k);
      }
    } else {
      // one row: each pixel's floats come from the row moved by its shift
      int sk[4];
      bool same = true;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        sk[k] = kPix == 4 ? s[g][k]
                : kPix == 1 || (col[g] + k) / c == col[g] / c ? s[g][0]
                                                              : s[g][kPix - 1];
        same &= sk[k] == sk[0];
      }
      if (same) {
        if (y[g] + sk[0] >= 0 && y[g] + sk[0] < p.h)
          load4(e[g], src + static_cast<long long>(sk[0]) * p.wc, p.img, end);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (y[g] + sk[k] >= 0 && y[g] + sk[k] < p.h)
            e[g][k] = __ldg(src + (k + static_cast<long long>(sk[k]) * p.wc));
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const I f = first + static_cast<I>(4 * kThreads * g);
    if (f + 4 <= p.n && p.out_vec) {
      *reinterpret_cast<float4*>(p.out + f) =
          make_float4(e[g][0], e[g][1], e[g][2], e[g][3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (f + k < p.n) p.out[f + k] = e[g][k];
    }
  }
}

template <bool kRows, int C, typename I>
cudaError_t launch(const Shift<I>& p, cudaStream_t s) {
  const unsigned long long blocks = (static_cast<unsigned long long>(p.n) +
                                     kTile - 1) / kTile;
  if (blocks > 0x7fffffffULL) return cudaErrorInvalidValue;
  shift_kernel<kRows, C, I><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

template <bool kRows, typename I>
cudaError_t launch_c(const Shift<I>& p, cudaStream_t s) {
  switch (p.c) {
    case 1: return launch<kRows, 1>(p, s);
    case 3: return launch<kRows, 3>(p, s);
    case 4: return launch<kRows, 4>(p, s);
    default: return launch<kRows, 0>(p, s);
  }
}

template <typename I>
cudaError_t run(const float* img, const int* shift, float* out, int b, int h,
                int w, int c, int axis, cudaStream_t s) {
  const int wc = w * c;
  const Shift<I> p{img, shift, out,
                   static_cast<I>(b) * static_cast<I>(h) * static_cast<I>(wc),
                   h, w, c, wc, Divider<I>(static_cast<I>(wc)),
                   Divider<I>(static_cast<I>(h)),
                   reinterpret_cast<uintptr_t>(out) % 16 == 0};
  return axis == 0 ? launch_c<true>(p, s) : launch_c<false>(p, s);
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
  const float* in = static_cast<const float*>(img);
  const int* sh = static_cast<const int*>(shift);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n = static_cast<int64_t>(b) * h * w * c;
  return static_cast<int>(
      n < (int64_t{1} << 31)
          ? run<uint32_t>(in, sh, o, b, h, w, c, axis, s)
          : run<uint64_t>(in, sh, o, b, h, w, c, axis, s));
}
