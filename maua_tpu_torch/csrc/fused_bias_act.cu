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
//     the bias is per row, bias[row % C] -- one load per row, no per-element
//     division;
//   * 1-D / 2-D input [..., C]: rows = prod(leading), cols = C, and the bias
//     is per column, bias[col].
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
// otherwise, and a grid-stride loop over both axes so any size fits the grid.
//
// Types: fp32 or bf16 in and out; arithmetic in fp32 with one rounding on the
// store. The bias is always fp32. The gradient's gain is slope * scale
// computed in fp32, as the JAX kernel computes `where(y >= 0, 1, slope) *
// scale`. Offsets are int64_t: the element count passes 2^31 at 1024^2 in bf16
// from batch 64.
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

// VEC elements per thread access: 16 / sizeof(T) on the vector path, 1 on the
// scalar path. The launcher picks VEC > 1 only if cols % VEC == 0 and both
// pointers are 16-byte aligned, so every row start stays aligned.
template <typename T, int VEC>
__global__ void __launch_bounds__(256) fused_bias_act_kernel(
    const T* __restrict__ x, const float* __restrict__ bias, T* __restrict__ out,
    int64_t rows, int64_t cols, int64_t channels, int bias_on_rows, float slope, float scale) {
    using P = Pack<T, VEC>;
    const int64_t col_step = (int64_t)blockDim.x * gridDim.x * VEC;
    const int64_t col0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
    for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
        const float row_bias = (bias != nullptr && bias_on_rows) ? bias[row % channels] : 0.f;
        const T* xr = x + row * cols;
        T* yr = out + row * cols;
        for (int64_t col = col0; col < cols; col += col_step) {
            const P in = *reinterpret_cast<const P*>(xr + col);
            P res;
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
                float b = row_bias;
                if (bias != nullptr && !bias_on_rows) b = bias[col + k];
                res.v[k] = from_float<T>(lrelu(to_float(in.v[k]) + b, slope, scale));
            }
            *reinterpret_cast<P*>(yr + col) = res;
        }
    }
}

template <typename T>
void launch(const void* x, const float* bias, void* out, int64_t rows, int64_t cols,
            int64_t channels, int bias_on_rows, float slope, float scale, cudaStream_t stream) {
    constexpr int VEC = 16 / sizeof(T);
    const bool vec = (cols % VEC == 0) && ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
    const int64_t per_row = vec ? cols / VEC : cols;
    // narrow rows (4x4 maps: 16 elements) get one warp, wide rows 256 threads
    const int64_t threads = per_row >= 256 ? 256 : ((per_row + 31) / 32) * 32;
    const int64_t bx = (per_row + threads - 1) / threads;
    const dim3 grid((unsigned)(bx < 65535 ? bx : 65535), (unsigned)(rows < 65535 ? rows : 65535));
    const T* xt = static_cast<const T*>(x);
    T* yt = static_cast<T*>(out);
    if (vec) {
        fused_bias_act_kernel<T, VEC><<<grid, (unsigned)threads, 0, stream>>>(
            xt, bias, yt, rows, cols, channels, bias_on_rows, slope, scale);
    } else {
        fused_bias_act_kernel<T, 1><<<grid, (unsigned)threads, 0, stream>>>(
            xt, bias, yt, rows, cols, channels, bias_on_rows, slope, scale);
    }
}

// dx = dy * (y >= 0 ? pos_gain : neg_gain). No bias, so no row structure: the
// tensor is one flat row of n elements (the [1, n] case of the forward's
// view), which keeps every thread busy on the 4x4 and 8x8 maps, where the
// forward's one row per block leaves most of a warp idle. Same vector rule:
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
