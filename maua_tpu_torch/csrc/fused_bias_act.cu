// Fused bias-add + scaled leaky-ReLU for Hopper (sm_90a): the forward and the
// gradient kernel.
//
//   forward:   out[i] = scale * (v >= 0 ? v : slope * v),   v = x[i] + bias[c(i)]
//   gradient:  dx[i]  = dy[i] * (y[i] >= 0 ? scale : slope * scale)
//
// The forward replaces the TPU kernel `_act_kernel`, the gradient the TPU
// kernel `_grad_kernel`, both of maua_tpu/ops/pallas_act.py (reached from
// `fused_leaky_relu_pallas` and its custom VJP through one `pl.pallas_call`).
// The Pallas version flattens to a [rows, cols] plane padded to (8, 128) tiles
// and, in the forward, streams a materialised bias plane of the same size
// through VMEM. Here the tensor is viewed as [rows, cols] without padding and
// the bias is never broadcast in memory:
//   * >= 3-D input [N, C, *spatial]: rows = N*C, cols = prod(spatial), and
//     the bias is per row, bias[row % C];
//   * 1-D / 2-D input [..., C]: rows = prod(leading), cols = C, and the bias
//     is per column, bias[col].
// The kernel walks that plane with one flat index i over rows * cols
// elements and finds the bias channel as (i / cols) % C or i % cols, once
// per 16-byte pack.
//
// The gradient takes its gate from the sign of the saved output (y >= 0 iff
// x + b >= 0, as scale > 0 and slope > 0), so the backward needs neither x nor
// the bias, and it views the tensor flat ([1, n]). It is linear in dy, so the
// same kernel is also its own derivative
// with respect to dy (the second-order rule of `_so_bwd`); the derivative with
// respect to y is zero almost everywhere. The bias gradient (a sum of dx over
// every axis but the channel axis) stays outside, in the caller, as in the
// JAX package.
//
// Bound: memory. The forward reads each element once and writes it once; the
// gradient reads dy and y and writes dx, 3 x elements x the dtype's size. At
// 1024^2 x batch 8 in fp32, the 17 StyledConv outputs of one render batch hold
// 131.4 M elements per sample, 8.4 GB moved per batch by the forward, so its
// least time is about 2.5 ms at the H100 SXM's 3.35 TB/s. The design follows
// from that: one pass, 16-byte vector loads and stores where a row's width and
// the pointers allow (4 fp32 or 8 bf16 per thread access), scalar accesses
// otherwise, and a grid-stride loop so any size fits the grid. The index is
// flat so that every thread of a warp is busy on any row length: one block
// per row leaves 1-4 threads of a warp busy on the 4x4 and 2x2 maps of a
// VAE's batch norms, and is no faster on wide rows (probe_fused_bias_act.py
// on an H100: [8, 32, 1024^2] fp32 0.737 ms against 0.711 ms flat).
//
// Types: fp32 or bf16 in and out; arithmetic in fp32 with one rounding on the
// store. The bias is always fp32. The gradient's gain is slope * scale
// computed in fp32, as the JAX kernel computes `where(y >= 0, 1, slope) *
// scale`. The forward's index is 32-bit below 2^31 elements and 64-bit from
// there (the element count reaches 2^31 at 1024^2 in bf16 from batch 64); the
// gradient's is 64-bit.
//
// The C entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError() so that the Python wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
    T v[N];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float lrelu(float v, float slope, float scale) {
    return (v >= 0.f ? v : v * slope) * scale;
}

// The forward: one index over all rows * cols elements. VEC elements per
// thread access: 16 / sizeof(T) on the vector path, 1 on the scalar path. The
// launcher picks VEC > 1 only if cols % VEC == 0 and both pointers are 16-byte
// aligned, so a pack never straddles two rows and takes one bias value with
// the bias on rows, VEC consecutive ones on columns. I is the index type:
// uint32_t (a 32-bit division by cols) when rows * cols < 2^31, so that
// i + step stays below 2^32, else int64_t.
template <typename T, int VEC, typename I>
__global__ void __launch_bounds__(256) fused_bias_act_kernel(
    const T* __restrict__ x, const float* __restrict__ bias, T* __restrict__ out,
    I n, I cols, I channels, int bias_on_rows, float slope, float scale) {
    using P = Pack<T, VEC>;
    const I step = (I)blockDim.x * gridDim.x * VEC;
    for (I i = ((I)blockIdx.x * blockDim.x + threadIdx.x) * VEC; i < n; i += step) {
        const P in = *reinterpret_cast<const P*>(x + i);
        const float row_bias = (bias != nullptr && bias_on_rows) ? bias[(i / cols) % channels] : 0.f;
        const I col = (bias != nullptr && !bias_on_rows) ? i % cols : 0;
        P res;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            const float b = (bias != nullptr && !bias_on_rows) ? bias[col + k] : row_bias;
            res.v[k] = from_float<T>(lrelu(to_float(in.v[k]) + b, slope, scale));
        }
        *reinterpret_cast<P*>(out + i) = res;
    }
}

template <typename T, typename I>
void launch_indexed(const T* x, const float* bias, T* out, int64_t n, int64_t cols, int64_t channels,
                 int bias_on_rows, bool vec, float slope, float scale, cudaStream_t stream) {
    constexpr int VEC = 16 / sizeof(T);
    const int64_t accesses = vec ? n / VEC : n;
    const int64_t blocks = (accesses + 255) / 256;
    const unsigned grid = (unsigned)(blocks < 65535 ? blocks : 65535);  // grid-stride beyond
    if (vec) {
        fused_bias_act_kernel<T, VEC, I><<<grid, 256, 0, stream>>>(
            x, bias, out, (I)n, (I)cols, (I)channels, bias_on_rows, slope, scale);
    } else {
        fused_bias_act_kernel<T, 1, I><<<grid, 256, 0, stream>>>(
            x, bias, out, (I)n, (I)cols, (I)channels, bias_on_rows, slope, scale);
    }
}

template <typename T>
void launch(const void* x, const float* bias, void* out, int64_t rows, int64_t cols,
            int64_t channels, int bias_on_rows, float slope, float scale, cudaStream_t stream) {
    constexpr int VEC = 16 / sizeof(T);
    const bool vec = (cols % VEC == 0) && ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
    const T* xt = static_cast<const T*>(x);
    T* yt = static_cast<T*>(out);
    const int64_t n = rows * cols;
    if (n < ((int64_t)1 << 31)) {
        launch_indexed<T, uint32_t>(xt, bias, yt, n, cols, channels, bias_on_rows, vec, slope, scale, stream);
    } else {
        launch_indexed<T, int64_t>(xt, bias, yt, n, cols, channels, bias_on_rows, vec, slope, scale, stream);
    }
}

// dx = dy * (y >= 0 ? pos_gain : neg_gain). No bias, so no row structure: the
// tensor is one flat row of n elements (the [1, n] case of the forward's
// view). Same vector rule:
// VEC > 1 only if n % VEC == 0 and all three pointers are 16-byte aligned.
template <typename T, int VEC>
__global__ void __launch_bounds__(256) fused_bias_act_grad_kernel(
    const T* __restrict__ dy, const T* __restrict__ y, T* __restrict__ dx, int64_t n,
    float pos_gain, float neg_gain) {
    using P = Pack<T, VEC>;
    const int64_t step = (int64_t)blockDim.x * gridDim.x * VEC;
    for (int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * VEC; i < n; i += step) {
        const P g = *reinterpret_cast<const P*>(dy + i);
        const P v = *reinterpret_cast<const P*>(y + i);
        P res;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            const float gain = to_float(v.v[k]) >= 0.f ? pos_gain : neg_gain;
            res.v[k] = from_float<T>(to_float(g.v[k]) * gain);
        }
        *reinterpret_cast<P*>(dx + i) = res;
    }
}

template <typename T>
void launch_grad(const void* dy, const void* y, void* dx, int64_t n, float slope, float scale,
                 cudaStream_t stream) {
    constexpr int VEC = 16 / sizeof(T);
    const bool vec = (n % VEC == 0) && ((uintptr_t)dy % 16 == 0) && ((uintptr_t)y % 16 == 0) &&
                     ((uintptr_t)dx % 16 == 0);
    const int64_t accesses = vec ? n / VEC : n;
    const int64_t threads = 256;
    const int64_t blocks = (accesses + threads - 1) / threads;
    const unsigned grid = (unsigned)(blocks < 65535 ? blocks : 65535);  // grid-stride beyond
    const T* g = static_cast<const T*>(dy);
    const T* v = static_cast<const T*>(y);
    T* out = static_cast<T*>(dx);
    const float neg = slope * scale;  // fp32 product, as the plain form computes it
    if (vec) {
        fused_bias_act_grad_kernel<T, VEC><<<grid, (unsigned)threads, 0, stream>>>(g, v, out, n, scale, neg);
    } else {
        fused_bias_act_grad_kernel<T, 1><<<grid, (unsigned)threads, 0, stream>>>(g, v, out, n, scale, neg);
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. bias may be NULL. Returns a cudaError_t.
extern "C" int fused_bias_act(const void* x, const void* bias, void* out, int64_t rows,
                              int64_t cols, int64_t channels, int bias_on_rows, int dtype,
                              float slope, float scale, void* stream) {
    if (rows <= 0 || cols <= 0) return (int)cudaSuccess;
    if (channels <= 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
    const float* b = static_cast<const float*>(bias);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        launch<float>(x, b, out, rows, cols, channels, bias_on_rows, slope, scale, s);
    } else {
        launch<__nv_bfloat16>(x, b, out, rows, cols, channels, bias_on_rows, slope, scale, s);
    }
    return (int)cudaGetLastError();
}

// n elements; dtype: 0 = float32, 1 = bfloat16; dy, y and dx share it.
// Returns a cudaError_t.
extern "C" int fused_bias_act_grad(const void* dy, const void* y, void* dx, int64_t n, int dtype,
                                   float slope, float scale, void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        launch_grad<float>(dy, y, dx, n, slope, scale, s);
    } else {
        launch_grad<__nv_bfloat16>(dy, y, dx, n, slope, scale, s);
    }
    return (int)cudaGetLastError();
}
