// upfirdn2d for Hopper (sm_90a): zero-stuff by `up`, pad or crop, FIR-filter
// and keep every `down`-th sample, in one pass over [N, C, H, W] planes.
//
//   out[o] = sum_t p[o * down + t] * kernel[k - 1 - t],  t in [0, k)
//
// per axis, where p is the input zero-stuffed by `up` and padded by pad0
// before (a negative pad crops), with one [kh, kw] filter shared by every
// plane. This kernel replaces no TPU kernel: the JAX package leaves upfirdn2d
// to XLA (maua_tpu/ops/upfirdn2d.py), and the port's plain form, a padded copy
// of the input followed by a depthwise F.conv2d that cuDNN hands to
// at::native's generic depthwise kernel, ran at about a seventh of the card's
// memory bandwidth. The autograd Function in ops/upfirdn2d.py calls this one
// kernel for the forward, the backward (the flipped filter, up and down
// swapped) and every higher order.
//
// Bound: HBM bytes. A 4x4 filter costs 16 FMAs an output, about 4 FLOP a byte
// in fp32, far under the H100's ridge of about 20. So the design moves each
// byte once:
//   * No intermediates. Padding and crops are index bounds of the staged
//     tile; `up = 2` is polyphase (an output takes only its own phase's taps,
//     no stuffed zero is read); `down = 2` computes only the kept outputs.
//   * A block stages one input tile of each of its planes, with its halo, in
//     shared memory as fp32, loading 16-byte chunks aligned in memory where
//     the input's pointer allows (a chunk that holds one element of the row
//     lies in that element's 16-byte granule, so it never leaves mapped
//     memory; its other elements are dropped) and single elements otherwise,
//     so odd widths such as the transposed conv's 1025 load whole chunks too.
//     A thread keeps several chunks in flight and steps through its items
//     without dividing, since the staging is latency- and not issue-bound.
//   * Each thread computes a VY x VX patch of outputs from registers: it
//     reads each input row of its window once, as float4s, and adds it into
//     every output row that uses it (21 shared-memory reads for 32 outputs
//     with 4x4 taps).
//   * Rows of outputs whose width is a multiple of VX go straight from the
//     registers as 16-byte stores; other widths (D's 257 and 255, the blur's
//     backward to 2r + 1) go through shared memory and leave as 16-byte
//     chunks aligned in memory, so no store writes a partial sector.
//   * Tiles are cut evenly over the plane (up to 128 x 32 outputs), and
//     small planes (4^2-16^2) are packed several to a block, so that one
//     launch keeps the card busy at G's and D's low resolutions.
//   * The filter stays on the device: each block reads the taps through
//     their pointer into a table of per-phase taps, flipping by index when
//     asked (`flip`), so a call is one launch and the host reads nothing.
// The tile adapts to the output plane, up, down and the tap count: up to 4,
// or up to 12 with up or down 2 (ADA's SYM6 pair, whose one caller always
// resamples); there is no other knob. On an H100 (700 W) the render
// blur [8, 32, 1025^2] -> 1024^2 in fp32 takes 0.895 ms against a 0.642 ms
// byte bound (72 %), where the plain form took 5.39 ms.
//
// Types: fp32 or bf16 in and out; the taps are rounded to the input's type
// (as the plain form casts them), products are summed in fp32 in a fixed
// order with no atomics, and the output is rounded once, so runs repeat bit
// for bit. Taps past the filter's end (a 3-tap filter in the 4-tap bucket) or
// of the other phase are zero: a non-finite input there gives NaN where the
// plain form multiplies only the taps it has.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so that the Python wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 128;              // most threads a block
constexpr size_t SMEM_LIMIT = 48 * 1024;  // shared memory a block, without opting in

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

__host__ __device__ __forceinline__ int floordiv(int a, int b) {
    return a >= 0 ? a / b : -((-a + b - 1) / b);
}

template <typename I>
__host__ __forceinline__ I ceil_div(I a, I b) { return (a + b - 1) / b; }

// What the launcher decides and every block reads.
struct Geom {
    const void* x;
    void* out;
    const float* taps;     // [kh, kw], fp32, on the device
    int64_t sn, sc;        // the input's strides of N and C in elements (each plane is dense)
    int64_t planes;        // N * C
    int channels;          // C
    int h, w, oh, ow;      // input and output plane sizes
    int pad_y0, pad_x0;
    int kh, kw, flip;
    int strips, row_groups, planes_per_block;  // a block's threads: strips x row_groups x planes
    int tile_h, tile_w;    // the staged input tile of one plane, halo included
    int pitch;             // its row pitch in shared memory: tile_w + 3 rounded up to 4
    int plane_floats;      // shared memory a plane: its input tile, or later its output tile
    int tiles_x, tiles;    // output tiles across a plane, and in a plane
    int vec_loads;         // the input's pointer is 16-byte aligned
    int vec_stores;        // each thread stores its rows of VX outputs whole; else through shared memory
};

// One axis of the geometry, at compile time. U = up, D = down (one of them
// 1), K = the tap bucket (4 or 12). A thread computes VY x VX outputs; along
// an axis an output reads NT window taps, and V outputs read NI inputs.
template <int U, int D, int K>
struct Cfg {
    static_assert((U == 1 || U == 2) && (D == 1 || D == 2) && !(U == 2 && D == 2), "up or down of 2");
    static constexpr int VX = K <= 4 ? 8 : 4;
    static constexpr int VY = K <= 4 ? 4 : 2;
    static constexpr int NT = U == 1 ? K : K / 2 + 1;
    static constexpr int NIX = U == 1 ? (VX - 1) * D + K : VX / 2 + NT - 1;
    static constexpr int NIY = U == 1 ? (VY - 1) * D + K : VY / 2 + NT - 1;
    static constexpr int PHASES = U * U;
    static constexpr int WT = PHASES * NT * NT;        // entries of the tap table
    static constexpr int WT_PADDED = (WT + 3) & ~3;
    // a thread's window starts on a multiple of 4 columns of the tile: its
    // rows are read as float4s (NIX4 floats, the last ones unused)
    static constexpr bool VEC_READ = (U == 1 ? VX * D : VX / 2) % 4 == 0;
    static constexpr int NIX4 = VEC_READ ? (NIX + 3) & ~3 : NIX;

    // First input sample of output o's window (o even when U = 2).
    __host__ __device__ static int in_start(int o, int pad0) {
        return U == 1 ? o * D - pad0 : o / 2 - floordiv(pad0, 2);
    }
    // Input samples that `outs` consecutive outputs read (outs even when U = 2).
    __host__ __device__ static int in_extent(int outs) {
        return U == 1 ? (outs - 1) * D + K : outs / 2 + NT - 1;
    }
    // The filter tap that window tap n of phase ph multiplies, or -1. With
    // U = 1 the window is the k taps in reverse; with U = 2 output 2m + ph
    // reads input m + E0 + n, E0 = -floor(pad0 / 2), through tap
    // k - 1 + ph - pad0 - 2 (E0 + n) where that lies in [0, k).
    __device__ static int tap(int n, int ph, int k, int pad0) {
        const int t = U == 1 ? k - 1 - n : k - 1 + ph - pad0 + 2 * floordiv(pad0, 2) - 2 * n;
        return (t >= 0 && t < k) ? t : -1;
    }
};

// Stage rows [r_lo, r_hi) and columns [c_lo, c_hi) of each plane's tile
// (the part that lies inside the plane) from the input, as fp32. LV elements
// a load: 16 / sizeof(T) in aligned chunks, or 1. Items (plane, row, chunk)
// are dealt to the threads in turn; a thread finds its next item by adding
// the block's stride with carries (no division in the loop) and keeps BATCH
// loads in flight before it stores them.
template <typename T, int LV>
__device__ __forceinline__ void stage(const T* __restrict__ x, float* tile, const int64_t* plane_off,
                                      const Geom& g, int np, int iy0, int ix0) {
    constexpr int BATCH = sizeof(T) == 4 ? 8 : 4;  // 16-byte loads in flight a thread (bf16 spills at 8)
    const int c_lo = max(ix0, 0), c_hi = min(ix0 + g.tile_w, g.w);
    const int r_lo = max(-iy0, 0), r_hi = min(g.tile_h, g.h - iy0);
    if (c_hi <= c_lo || r_hi <= r_lo) return;
    const int rows = r_hi - r_lo;
    const int per_row = LV == 1 ? c_hi - c_lo : (c_hi - c_lo + LV - 1) / LV + 1;
    const int step = blockDim.x;
    const int dj = step % per_row, dr = (step / per_row) % rows, dp = step / per_row / rows;
    int j = threadIdx.x % per_row, r = (threadIdx.x / per_row) % rows, p = threadIdx.x / per_row / rows;
    while (p < np) {
        Pack<T, LV> v[BATCH];
        int dst[BATCH], lo[BATCH], hi[BATCH];  // tile index of the chunk's first element; its valid elements [lo, hi)
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
            dst[b] = 0;
            lo[b] = LV;
            hi[b] = 0;
            if (p < np) {
                const int64_t rw = plane_off[p] + (int64_t)(iy0 + r_lo + r) * g.w;  // the row's column 0
                const int64_t at = LV == 1 ? rw + c_lo + j : ((rw + c_lo) & ~(int64_t)(LV - 1)) + (int64_t)j * LV;
                const int c0 = (int)(at - rw);
                if (c0 < c_hi) {
                    v[b] = *reinterpret_cast<const Pack<T, LV>*>(x + at);
                    dst[b] = (p * g.tile_h + r_lo + r) * g.pitch + c0 - ix0;
                    lo[b] = c_lo - c0;
                    hi[b] = c_hi - c0;
                }
                j += dj;
                r += dr;
                p += dp;
                if (j >= per_row) {
                    j -= per_row;
                    ++r;
                }
                if (r >= rows) {
                    r -= rows;
                    ++p;
                }
            }
        }
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
            float* d = tile + dst[b];
            if (lo[b] <= 0 && hi[b] >= LV) {
#pragma unroll
                for (int e = 0; e < LV; ++e) d[e] = to_float(v[b].v[e]);
            } else {
#pragma unroll
                for (int e = 0; e < LV; ++e) {
                    if (e >= lo[b] && e < hi[b]) d[e] = to_float(v[b].v[e]);
                }
            }
        }
    }
}

// Store each plane's output tile [th][tw] (fp32 in shared memory) to rows
// [oy0, oy0 + th) and columns [ox0, ox0 + tw) of its output plane, clipped to
// the plane: whole 16-byte chunks aligned in memory (the output's pointer is)
// where they lie inside the row, single elements at the row's ends. The
// items are dealt as in `stage`.
template <typename T>
__device__ __forceinline__ void put_tile(T* __restrict__ out, const float* otile, const Geom& g, int np,
                                         int64_t p0, int oy0, int ox0, int th, int tw) {
    constexpr int LV = 16 / sizeof(T);
    const int rows = min(th, g.oh - oy0), c_hi = min(ox0 + tw, g.ow);
    const int per_row = (c_hi - ox0 + LV - 1) / LV + 1;
    const int step = blockDim.x;
    const int dj = step % per_row, dr = (step / per_row) % rows, dp = step / per_row / rows;
    int j = threadIdx.x % per_row, r = (threadIdx.x / per_row) % rows, p = threadIdx.x / per_row / rows;
    while (p < np) {
        const int64_t rw = ((p0 + p) * g.oh + oy0 + r) * (int64_t)g.ow;  // the row's column 0
        const int64_t at = ((rw + ox0) & ~(int64_t)(LV - 1)) + (int64_t)j * LV;
        if (at < rw + c_hi) {
            const int c0 = (int)(at - rw);
            const float* src = otile + (p * th + r) * tw - ox0;  // src[c] is column c
            if (c0 >= ox0 && c0 + LV <= c_hi) {
                Pack<T, LV> v;
#pragma unroll
                for (int e = 0; e < LV; ++e) v.v[e] = from_float<T>(src[c0 + e]);
                *reinterpret_cast<Pack<T, LV>*>(out + at) = v;
            } else {
#pragma unroll
                for (int e = 0; e < LV; ++e) {
                    if (c0 + e >= ox0 && c0 + e < c_hi) out[at + e] = from_float<T>(src[c0 + e]);
                }
            }
        }
        j += dj;
        r += dr;
        p += dp;
        if (j >= per_row) {
            j -= per_row;
            ++r;
        }
        if (r >= rows) {
            r -= rows;
            ++p;
        }
    }
}

// One block: one output tile of `planes_per_block` planes. Shared memory:
// the input tiles (fp32, rows `pitch` apart; later the output tiles, where
// they go through shared memory), the tap table (fp32), then the planes'
// offsets (int64).
template <typename T, int U, int D, int K>
__global__ void __launch_bounds__(THREADS, 6) upfirdn2d_kernel(const Geom g) {
    using C = Cfg<U, D, K>;
    extern __shared__ __align__(16) unsigned char smem[];
    float* tile = reinterpret_cast<float*>(smem);
    float* wt = tile + g.planes_per_block * g.plane_floats;
    int64_t* plane_off = reinterpret_cast<int64_t*>(wt + C::WT_PADDED);

    const int t_idx = (int)(blockIdx.x % (unsigned)g.tiles);
    const int64_t p0 = (int64_t)(blockIdx.x / (unsigned)g.tiles) * g.planes_per_block;
    const int np = g.planes - p0 < g.planes_per_block ? (int)(g.planes - p0) : g.planes_per_block;
    const int th = g.row_groups * C::VY, tw = g.strips * C::VX;
    const int oy0 = (t_idx / g.tiles_x) * th, ox0 = (t_idx % g.tiles_x) * tw;
    const int iy0 = C::in_start(oy0, g.pad_y0), ix0 = C::in_start(ox0, g.pad_x0);

    // the tap table wt[phase y][phase x][ny][nx], in the input's type
    for (int i = threadIdx.x; i < C::WT; i += blockDim.x) {
        const int nx = i % C::NT, ny = (i / C::NT) % C::NT, ph = i / (C::NT * C::NT);
        int ty = C::tap(ny, ph / U, g.kh, g.pad_y0), tx = C::tap(nx, ph % U, g.kw, g.pad_x0);
        float v = 0.f;
        if (ty >= 0 && tx >= 0) {
            if (g.flip) {
                ty = g.kh - 1 - ty;
                tx = g.kw - 1 - tx;
            }
            v = to_float(from_float<T>(g.taps[ty * g.kw + tx]));
        }
        wt[i] = v;
    }
    for (int i = threadIdx.x; i < np; i += blockDim.x) {
        const int64_t p = p0 + i;
        plane_off[i] = (p / g.channels) * g.sn + (p % g.channels) * g.sc;
    }
    // zeros where the tile reaches past the plane: the padding
    if (iy0 < 0 || ix0 < 0 || iy0 + g.tile_h > g.h || ix0 + g.tile_w > g.w) {
        float4* t4 = reinterpret_cast<float4*>(tile);
        for (int i = threadIdx.x; i < np * g.tile_h * g.pitch / 4; i += blockDim.x) t4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    const T* x = static_cast<const T*>(g.x);
    if (g.vec_loads) {
        stage<T, (int)(16 / sizeof(T))>(x, tile, plane_off, g, np, iy0, ix0);
    } else {
        stage<T, 1>(x, tile, plane_off, g, np, iy0, ix0);
    }
    __syncthreads();

    const int s = threadIdx.x % g.strips;
    const int rg = (threadIdx.x / g.strips) % g.row_groups;
    const int p = threadIdx.x / (g.strips * g.row_groups);
    const int oy = oy0 + rg * C::VY, ox = ox0 + s * C::VX;
    const bool active = p < np && oy < g.oh && ox < g.ow;
    const int ry = C::in_start(oy, g.pad_y0) - iy0, rx = C::in_start(ox, g.pad_x0) - ix0;
    const float* src = tile + (p * g.tile_h + ry) * g.pitch + rx;

    float acc[C::VY][C::VX];
#pragma unroll
    for (int vy = 0; vy < C::VY; ++vy) {
#pragma unroll
        for (int vx = 0; vx < C::VX; ++vx) acc[vy][vx] = 0.f;
    }
    // each input row of the window once, into every output row that reads it;
    // an output sums its taps in row order, then column order
    if (active) {
#pragma unroll
        for (int iy = 0; iy < C::NIY; ++iy) {
            float r[C::NIX4];
            if (C::VEC_READ) {
#pragma unroll
                for (int i = 0; i < C::NIX4; i += 4) {
                    const float4 q = *reinterpret_cast<const float4*>(src + iy * g.pitch + i);
                    r[i] = q.x;
                    r[i + 1] = q.y;
                    r[i + 2] = q.z;
                    r[i + 3] = q.w;
                }
            } else {
#pragma unroll
                for (int ix = 0; ix < C::NIX; ++ix) r[ix] = src[iy * g.pitch + ix];
            }
#pragma unroll
            for (int vy = 0; vy < C::VY; ++vy) {
                const int ny = U == 1 ? iy - vy * D : iy - vy / 2;
                if (ny < 0 || ny >= C::NT) continue;
                const int phy = U == 1 ? 0 : (vy & 1);
#pragma unroll
                for (int vx = 0; vx < C::VX; ++vx) {
                    const int phx = U == 1 ? 0 : (vx & 1);
                    const int first = U == 1 ? vx * D : vx / 2;
                    const float* w = wt + ((phy * U + phx) * C::NT + ny) * C::NT;
#pragma unroll
                    for (int nx = 0; nx < C::NT; ++nx) acc[vy][vx] = fmaf(r[first + nx], w[nx], acc[vy][vx]);
                }
            }
        }
    }

    T* out = static_cast<T*>(g.out);
    if (g.vec_stores) {  // rows of VX outputs, aligned: straight from the registers
        if (!active) return;
        T* at = out + ((p0 + p) * g.oh + oy) * (int64_t)g.ow + ox;
#pragma unroll
        for (int vy = 0; vy < C::VY; ++vy) {
            if (oy + vy >= g.oh) break;
            Pack<T, C::VX> pk;
#pragma unroll
            for (int vx = 0; vx < C::VX; ++vx) pk.v[vx] = from_float<T>(acc[vy][vx]);
            *reinterpret_cast<Pack<T, C::VX>*>(at + (int64_t)vy * g.ow) = pk;
        }
        return;
    }
    // other widths: through shared memory, then whole aligned chunks
    __syncthreads();  // every thread has read the input tile: its space takes the outputs
    if (active) {
        float* o = tile + (p * th + rg * C::VY) * tw + s * C::VX;
#pragma unroll
        for (int vy = 0; vy < C::VY; ++vy) {
#pragma unroll
            for (int vx = 0; vx < C::VX; vx += 4) {
                *reinterpret_cast<float4*>(o + vy * tw + vx) =
                    make_float4(acc[vy][vx], acc[vy][vx + 1], acc[vy][vx + 2], acc[vy][vx + 3]);
            }
        }
    }
    __syncthreads();
    put_tile<T>(out, tile, g, np, p0, oy0, ox0, th, tw);
}

template <typename T, int U, int D, int K>
int launch(Geom g, cudaStream_t stream) {
    using C = Cfg<U, D, K>;
    // a tile of up to 16 strips x 8 row groups (128 x 32 outputs for 4 taps),
    // cut evenly over the plane; the rest of the 128 threads take further
    // planes when the plane is small
    const int units_x = (int)ceil_div<int64_t>(g.ow, C::VX), units_y = (int)ceil_div<int64_t>(g.oh, C::VY);
    g.strips = ceil_div(units_x, ceil_div(units_x, 16));
    const int most_rows = THREADS / g.strips;
    g.row_groups = ceil_div(units_y, ceil_div(units_y, most_rows));
    g.planes_per_block = (int)std::min<int64_t>(g.planes, std::max(1, THREADS / (g.strips * g.row_groups)));
    auto smem = [&]() {
        g.tile_w = C::in_extent(g.strips * C::VX);
        g.tile_h = C::in_extent(g.row_groups * C::VY);
        g.pitch = (g.tile_w + 3 + 3) & ~3;
        g.plane_floats = std::max(g.tile_h * g.pitch, g.row_groups * C::VY * g.strips * C::VX);
        return (size_t)g.planes_per_block * (sizeof(float) * g.plane_floats + sizeof(int64_t)) +
               sizeof(float) * C::WT_PADDED;
    };
    while (smem() > SMEM_LIMIT) {  // fewer planes, then fewer rows, then fewer strips
        if (g.planes_per_block > 1) {
            g.planes_per_block /= 2;
        } else if (g.row_groups > 1) {
            g.row_groups /= 2;
        } else if (g.strips > 1) {
            g.strips /= 2;
        } else {
            return (int)cudaErrorInvalidConfiguration;
        }
    }
    const size_t bytes = smem();
    g.tiles_x = ceil_div(units_x, g.strips);
    const int64_t tiles = (int64_t)g.tiles_x * ceil_div(units_y, g.row_groups);
    const int64_t blocks = tiles * ceil_div<int64_t>(g.planes, g.planes_per_block);
    if (tiles > INT32_MAX || blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
    g.tiles = (int)tiles;
    g.vec_loads = (uintptr_t)g.x % 16 == 0;
    g.vec_stores = g.ow % C::VX == 0;  // rows start VX-aligned: the output's pointer is 32-byte aligned
    const int threads = g.strips * g.row_groups * g.planes_per_block;
    upfirdn2d_kernel<T, U, D, K><<<(unsigned)blocks, threads, bytes, stream>>>(g);
    return (int)cudaSuccess;
}

template <typename T>
int launch_t(const Geom& g, int up, int down, cudaStream_t stream) {
    if (g.kh <= 4 && g.kw <= 4) {
        if (up == 1 && down == 1) return launch<T, 1, 1, 4>(g, stream);
        if (up == 2 && down == 1) return launch<T, 2, 1, 4>(g, stream);
        if (up == 1 && down == 2) return launch<T, 1, 2, 4>(g, stream);
    } else {  // up to 12 taps only with resampling: ADA's SYM6 pair
        if (up == 2 && down == 1) return launch<T, 2, 1, 12>(g, stream);
        if (up == 1 && down == 2) return launch<T, 1, 2, 12>(g, stream);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: [N, C, H, W] with dense planes and strides sn, sc (elements) for N and C;
// taps: [kh, kw] fp32 on the device, 1 <= kh, kw <= 4, or <= 12 when up or
// down is 2, flipped by index when flip != 0; out: [N, C, oh, ow], contiguous
// and 32-byte aligned (as every allocation of PyTorch's CUDA allocator is).
// up, down: the same on both axes, 1 or 2, not both 2. dtype: 0 = float32,
// 1 = bfloat16 (x and out). The caller has checked that oh and ow follow from
// the rest. Returns a cudaError_t.
extern "C" int upfirdn2d(const void* x, const void* taps, void* out, int64_t n, int64_t c, int64_t sn,
                         int64_t sc, int h, int w, int oh, int ow, int up, int down, int pad_x0,
                         int pad_y0, int kh, int kw, int flip, int dtype, void* stream) {
    if (n <= 0 || c <= 0 || oh <= 0 || ow <= 0) return (int)cudaSuccess;
    if (h <= 0 || w <= 0 || kh < 1 || kw < 1 || kh > 12 || kw > 12 || (dtype != 0 && dtype != 1)) {
        return (int)cudaErrorInvalidValue;
    }
    if ((uintptr_t)out % 32 != 0) return (int)cudaErrorMisalignedAddress;
    Geom g{};
    g.x = x;
    g.out = out;
    g.taps = static_cast<const float*>(taps);
    g.sn = sn;
    g.sc = sc;
    g.planes = n * c;
    g.channels = (int)c;
    g.h = h;
    g.w = w;
    g.oh = oh;
    g.ow = ow;
    g.pad_y0 = pad_y0;
    g.pad_x0 = pad_x0;
    g.kh = kh;
    g.kw = kw;
    g.flip = flip != 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int err = dtype == 0 ? launch_t<float>(g, up, down, s) : launch_t<__nv_bfloat16>(g, up, down, s);
    if (err != (int)cudaSuccess) return err;
    return (int)cudaGetLastError();
}
