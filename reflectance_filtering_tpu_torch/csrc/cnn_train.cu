// K7 — fused skip-layer trunk for training: forward and backward.
//
// Replaces reflectance_filtering_tpu/ops/cnn_train_pallas.py::_fwd_kernel and
// ::_bwd_kernel (reached via skip_trunk_pre / _make_trunk, dispatched from
// models/networks.py::_apply_skip_layers).
//
// What it computes, per pixel p of x [P, ci] (channels last):
//   h_0 = relu(x W_0 + b_0), h_i = relu(h_{i-1} W_i + b_i)  (i < n, width f)
//   pre = [h_0 .. h_{n-1}] W_f + b_f                         [P, cout]
// and, given the cotangent g = dL/dpre [P, cout], every parameter gradient
// summed over all pixels plus (optionally) dx = dL/dx [P, ci].  Weights are
// dynamic (they change every training step), so they are read from a device
// buffer on every launch: one flat f32 vector in the order
//   W_0 [ci][f], b_0 [f], W_1 [f][f], b_1 [f], ..., W_f [n*f][cout], b_f [cout]
// (each W stored [in][out], the JAX kernels' [0, 0] slice); the gradient has
// the same layout (ops/cnn_train_kernel.py packs and unpacks it).
//
// What bounds it on an H100: arithmetic.  The flagship (n=5, ci=3, f=32,
// cout=1) costs 4,352 FMAs per pixel forward and about 13 k backward
// (rematerialisation 4,352, the chain 4,256, the weight gradients 4,352)
// against 12-16 bytes of device memory per pixel, far on the compute side.
// The design:
//   * A block takes a tile of TP = 64 pixels; every activation of the tile
//     lives in shared memory as [channel][TP + 4] (pixel fastest, rows padded
//     by 4 floats so float4 reads of different rows fall in different banks).
//   * Each layer is a small matrix product over the tile.  A work item is
//     (8 output channels, 1 pixel): consecutive threads take consecutive
//     pixels of the same 8 channels, so the weight reads (two float4) are
//     uniform across a warp (a broadcast) and the activation reads are
//     conflict-free; 8 FMAs per activation read.  The skip fuse is
//     accumulated layer by layer: no [P, n*f] concat exists anywhere.
//   * The backward rematerialises the tile's activations (storing five
//     [P, 32] maps would be 839 MB at batch 20 x 256x256), then runs the
//     chain dz_i = (W_f,i g + W_{i+1} dz_{i+1}) * [h_i > 0] in place over
//     h_i, and forms dW_i = sum_p a_{i-1} (x) dz_i as 4x4 register tiles over
//     float4 pixel runs, split four ways over the tile's pixels when the
//     layer has fewer tiles than threads.
//   * The sum over all pixels is the one part the TPU's sequential grid did
//     for free.  Here blocks run in no order, so there is no float atomic
//     anywhere: a persistent grid of a fixed number of blocks walks the tiles
//     in a fixed order, each block accumulates its tiles into its own row of
//     a [blocks, params] buffer (in shared memory while it fits), and a second
//     kernel sums the rows in block order.  The gradient is bitwise the same
//     from run to run, which the resume-equals-uninterrupted contract needs.
//   * Where the tile's activations do not fit the shared-memory budget (wide
//     or deep trunks) they live in a per-block slice of a device workspace
//     instead; the code is the same, through generic pointers.
// Plain f32 FMAs: the TPU kernel's bf16x3 splits existed only for its matrix
// unit.  Any configuration that fits_fused_trunk admits launches: n >= 1,
// ci <= 8, f a multiple of 8 in 8..256, cout <= 8.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;             // pixels per tile
constexpr int kStride = kTile + 4;    // row stride of a tile array, floats
constexpr int kQuarter = 4;           // dW pixel split (kTile / 16)
constexpr int kBudget = 100 * 1024;   // shared-memory budget of one block
                                      // of the backward (two per SM)

struct Shape {
  int n, ci, f, cout;
  int ci4;        // ci rounded up to 4 (zero rows)
  int64_t p;      // pixels
  int64_t tiles;
};

__host__ __device__ inline int64_t off_w(const Shape& s, int l) {
  // offset of W_l in the flat parameter vector (l == n: the fuse)
  if (l == 0) return 0;
  const int64_t first = static_cast<int64_t>(s.ci) * s.f + s.f;
  return first + static_cast<int64_t>(l - 1) * (static_cast<int64_t>(s.f) * s.f + s.f);
}

__host__ __device__ inline int fan_in(const Shape& s, int l) {
  return l == 0 ? s.ci : s.f;
}

__host__ __device__ inline int64_t num_params(const Shape& s) {
  return off_w(s, s.n) + static_cast<int64_t>(s.n) * s.f * s.cout + s.cout;
}

// row stride of the partial-gradient buffer: a multiple of 4 floats, so
// the act slices that follow the rows stay 16-byte aligned
__host__ __device__ inline int64_t row_stride(const Shape& s) {
  return (num_params(s) + 3) / 4 * 4;
}

// Where the backward keeps things (in floats); act and acc are in shared
// memory when the budget allows, else in the workspace.
struct Plan {
  int blocks;
  int64_t act_floats;   // n * f * kStride
  int64_t core_floats;  // x, g tiles and the dW reduction scratch
  bool act_shared, acc_shared;
  int smem_bytes;
  int64_t work_floats;  // workspace: partial rows [+ act slices]
};

// ---------------------------------------------------------------------------
// device helpers shared by the two kernels
// ---------------------------------------------------------------------------

// Load a tile of x [P, ci] into xs [ci4][kStride] (zero rows above ci and
// zero columns past P), and g likewise when given.
__device__ void load_tile(const Shape& s, int64_t p0, const float* __restrict__ src,
                          int c, int rows, float* dst) {
  for (int i = threadIdx.x; i < rows * kTile; i += blockDim.x) {
    const int ch = i / kTile, p = i % kTile;
    const int64_t pix = p0 + p;
    dst[ch * kStride + p] = (ch < c && pix < s.p) ? src[pix * c + ch] : 0.0f;
  }
}

// One layer over the tile: out[o][p] = relu(sum_i in[i][p] W[i][o] + b[o]).
__device__ void layer_fwd(const Shape& s, const float* __restrict__ w, int l,
                          const float* in, float* out) {
  const int fin = fan_in(s, l);
  const float* W = w + off_w(s, l);
  const float* b = W + static_cast<int64_t>(fin) * s.f;
  const int groups = s.f / 8;
  for (int it = threadIdx.x; it < groups * kTile; it += blockDim.x) {
    const int og = it / kTile, p = it % kTile;
    float acc[8];
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(b + og * 8));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(b + og * 8 + 4));
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.0f;
    for (int i = 0; i < fin; ++i) {
      const float a = in[i * kStride + p];
      const float4 w0 = __ldg(reinterpret_cast<const float4*>(W + i * s.f + og * 8));
      const float4 w1 = __ldg(reinterpret_cast<const float4*>(W + i * s.f + og * 8 + 4));
      acc[0] = fmaf(a, w0.x, acc[0]);
      acc[1] = fmaf(a, w0.y, acc[1]);
      acc[2] = fmaf(a, w0.z, acc[2]);
      acc[3] = fmaf(a, w0.w, acc[3]);
      acc[4] = fmaf(a, w1.x, acc[4]);
      acc[5] = fmaf(a, w1.y, acc[5]);
      acc[6] = fmaf(a, w1.z, acc[6]);
      acc[7] = fmaf(a, w1.w, acc[7]);
    }
    const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int k = 0; k < 8; ++k)
      out[(og * 8 + k) * kStride + p] = fmaxf(acc[k] + bb[k], 0.0f);
  }
}

// Rematerialise all n layers of the tile into act (n slots of f rows).
__device__ void remat(const Shape& s, const float* __restrict__ w, const float* xs,
                      float* act) {
  const int64_t slot = static_cast<int64_t>(s.f) * kStride;
  const float* in = xs;
  for (int l = 0; l < s.n; ++l) {
    float* out = act + l * slot;
    layer_fwd(s, w, l, in, out);
    __syncthreads();
    in = out;
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
trunk_fwd_kernel(Shape s, const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ pre) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);           // [ci4][kStride]
  float* act = xs + s.ci4 * kStride;                     // 2 slots [f][kStride]
  float* fuse = act + 2 * s.f * kStride;                 // [cout][kStride]
  const int64_t slot = static_cast<int64_t>(s.f) * kStride;
  const float* wf = w + off_w(s, s.n);
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kTile;

  load_tile(s, p0, x, s.ci, s.ci4, xs);
  for (int i = threadIdx.x; i < s.cout * kTile; i += blockDim.x)
    fuse[(i / kTile) * kStride + i % kTile] = 0.0f;
  __syncthreads();
  const float* in = xs;
  for (int l = 0; l < s.n; ++l) {
    float* out = act + (l & 1) * slot;
    layer_fwd(s, w, l, in, out);
    __syncthreads();
    // skip fuse, layer by layer: fuse[c][p] += sum_ch h_l[ch][p] Wf[l*f+ch][c]
    for (int it = threadIdx.x; it < s.cout * kTile; it += blockDim.x) {
      const int c = it / kTile, p = it % kTile;
      float acc = fuse[c * kStride + p];
      const float* wl = wf + static_cast<int64_t>(l) * s.f * s.cout + c;
      for (int ch = 0; ch < s.f; ++ch)
        acc = fmaf(out[ch * kStride + p], __ldg(wl + ch * s.cout), acc);
      fuse[c * kStride + p] = acc;
    }
    __syncthreads();
    in = out;
  }
  const float* bf = wf + static_cast<int64_t>(s.n) * s.f * s.cout;
  for (int it = threadIdx.x; it < s.cout * kTile; it += blockDim.x) {
    const int c = it % s.cout, p = it / s.cout;   // coalesced [P, cout] store
    const int64_t pix = p0 + p;
    if (pix < s.p) pre[pix * s.cout + c] = fuse[c * kStride + p] + __ldg(bf + c);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// acc[off + in*f + o] += sum_p a[in][p] dz[o][p] for in < fin (a has fin4
// rows, zero past fin); 4x4 register tiles, float4 pixel runs, the pixels
// split kQuarter ways when the layer has fewer tiles than threads (the
// partial sums then meet in red, in a fixed order).
__device__ void weight_grad(const Shape& s, int fin, int fin4, const float* a,
                            const float* dz, float* acc, int64_t off, float* red) {
  const int ob = s.f / 4;
  const int nblk = (fin4 / 4) * ob;
  // the largest split in {4, 2, 1} whose work items fit one pass of the
  // block (and so red, 16 floats per thread)
  int q = kQuarter;
  while (q > 1 && q * nblk > static_cast<int>(blockDim.x)) q /= 2;
  const int run = kTile / q;
  for (int it = threadIdx.x; it < nblk * q; it += blockDim.x) {
    const int blk = it % nblk, part = it / nblk;
    const int ib = blk / ob, o0 = (blk % ob) * 4;
    const int i0 = ib * 4;
    float sum[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) sum[k] = 0.0f;
    for (int p = part * run; p < (part + 1) * run; p += 4) {
      float4 av[4], dv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        av[r] = *reinterpret_cast<const float4*>(a + (i0 + r) * kStride + p);
        dv[r] = *reinterpret_cast<const float4*>(dz + (o0 + r) * kStride + p);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float t = sum[r * 4 + c];
          t = fmaf(av[r].x, dv[c].x, t);
          t = fmaf(av[r].y, dv[c].y, t);
          t = fmaf(av[r].z, dv[c].z, t);
          t = fmaf(av[r].w, dv[c].w, t);
          sum[r * 4 + c] = t;
        }
      }
    }
    if (q == 1) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (i0 + r >= fin) break;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[off + static_cast<int64_t>(i0 + r) * s.f + o0 + c] += sum[r * 4 + c];
      }
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k) red[(part * nblk + blk) * 16 + k] = sum[k];
    }
  }
  if (q == 1) return;
  __syncthreads();
  for (int e = threadIdx.x; e < nblk * 16; e += blockDim.x) {
    const int blk = e / 16, k = e % 16;
    const int i = (blk / ob) * 4 + k / 4, o = (blk % ob) * 4 + k % 4;
    if (i >= fin) continue;
    float t = red[blk * 16 + k];
    for (int part = 1; part < q; ++part) t += red[(part * nblk + blk) * 16 + k];
    acc[off + static_cast<int64_t>(i) * s.f + o] += t;
  }
}

// acc[off + r] += sum_p v[r][p] for r < rows (float4 runs, fixed order).
__device__ void row_sums(int rows, const float* v, float* acc, int64_t off) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    float t = 0.0f;
    for (int p = 0; p < kTile; p += 4) {
      const float4 q = *reinterpret_cast<const float4*>(v + r * kStride + p);
      t += q.x;
      t += q.y;
      t += q.z;
      t += q.w;
    }
    acc[off + r] += t;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
trunk_bwd_kernel(Shape s, Plan plan, const float* __restrict__ x,
                 const float* __restrict__ g, const float* __restrict__ w,
                 float* __restrict__ dx, float* __restrict__ work) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);            // [ci4][kStride]
  float* gs = xs + s.ci4 * kStride;                       // [cout][kStride]
  float* red = gs + s.cout * kStride;                     // 16 * kThreads
  float* tail = red + 16 * kThreads;
  const int64_t np = num_params(s);
  float* partial = work + blockIdx.x * row_stride(s);     // this block's row
  float* act = plan.act_shared ? tail
      : work + plan.blocks * row_stride(s) + blockIdx.x * plan.act_floats;
  float* acc = plan.acc_shared ? (plan.act_shared ? tail + plan.act_floats : tail)
                               : partial;
  const int64_t slot = static_cast<int64_t>(s.f) * kStride;
  const int64_t offf = off_w(s, s.n);
  const float* wf = w + offf;

  for (int64_t j = threadIdx.x; j < np; j += blockDim.x) acc[j] = 0.0f;
  for (int64_t t = blockIdx.x; t < s.tiles; t += gridDim.x) {
    const int64_t p0 = t * kTile;
    __syncthreads();
    load_tile(s, p0, x, s.ci, s.ci4, xs);
    load_tile(s, p0, g, s.cout, s.cout, gs);
    __syncthreads();
    remat(s, w, xs, act);

    // fuse head: dbf[c] = sum_p g[c][p]; dWf[l*f+ch][c] = sum_p h_l[ch][p] g[c][p]
    row_sums(s.cout, gs, acc, offf + static_cast<int64_t>(s.n) * s.f * s.cout);
    for (int it = threadIdx.x; it < s.n * s.f * s.cout; it += blockDim.x) {
      const int c = it % s.cout, row = it / s.cout;       // row = l*f + ch
      const float* h = act + row * static_cast<int64_t>(kStride);
      float t2 = 0.0f;
      for (int p = 0; p < kTile; p += 4) {
        const float4 hv = *reinterpret_cast<const float4*>(h + p);
        const float4 gv = *reinterpret_cast<const float4*>(gs + c * kStride + p);
        t2 = fmaf(hv.x, gv.x, t2);
        t2 = fmaf(hv.y, gv.y, t2);
        t2 = fmaf(hv.z, gv.z, t2);
        t2 = fmaf(hv.w, gv.w, t2);
      }
      acc[offf + static_cast<int64_t>(row) * s.cout + c] += t2;
    }
    __syncthreads();

    // the chain, last layer first; dz_l overwrites h_l in place
    for (int l = s.n - 1; l >= 0; --l) {
      float* h = act + l * slot;
      const float* dnext = act + (l + 1) * slot;           // dz_{l+1}
      const float* wn = w + off_w(s, l + 1);               // W_{l+1} [f][f]
      const int groups = s.f / 8;
      for (int it = threadIdx.x; it < groups * kTile; it += blockDim.x) {
        const int og = it / kTile, p = it % kTile;
        float acc8[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float* wfr = wf + (static_cast<int64_t>(l) * s.f + og * 8 + k) * s.cout;
          float t2 = 0.0f;
          for (int c = 0; c < s.cout; ++c) t2 = fmaf(__ldg(wfr + c), gs[c * kStride + p], t2);
          acc8[k] = t2;
        }
        if (l < s.n - 1) {
          for (int o = 0; o < s.f; o += 4) {
            const float d0 = dnext[(o + 0) * kStride + p];
            const float d1 = dnext[(o + 1) * kStride + p];
            const float d2 = dnext[(o + 2) * kStride + p];
            const float d3 = dnext[(o + 3) * kStride + p];
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const float4 wv = __ldg(reinterpret_cast<const float4*>(
                  wn + (og * 8 + k) * s.f + o));
              float t2 = acc8[k];
              t2 = fmaf(wv.x, d0, t2);
              t2 = fmaf(wv.y, d1, t2);
              t2 = fmaf(wv.z, d2, t2);
              t2 = fmaf(wv.w, d3, t2);
              acc8[k] = t2;
            }
          }
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float* e = h + (og * 8 + k) * kStride + p;
          *e = *e > 0.0f ? acc8[k] : 0.0f;
        }
      }
      __syncthreads();
      // dW_l, db_l from a_{l-1} (x for l = 0) and dz_l
      const int fin = fan_in(s, l);
      const float* a = l == 0 ? xs : act + (l - 1) * slot;
      weight_grad(s, fin, l == 0 ? s.ci4 : s.f, a, h, acc, off_w(s, l), red);
      row_sums(s.f, h, acc, off_w(s, l) + static_cast<int64_t>(fin) * s.f);
      if (l == 0 && dx != nullptr) {
        // dx[p][c] = sum_o W_0[c][o] dz_0[o][p]
        for (int it = threadIdx.x; it < s.ci * kTile; it += blockDim.x) {
          const int c = it / kTile, p = it % kTile;
          const float* w0 = w + static_cast<int64_t>(c) * s.f;
          float t2 = 0.0f;
          for (int o = 0; o < s.f; o += 4) {
            const float4 wv = __ldg(reinterpret_cast<const float4*>(w0 + o));
            t2 = fmaf(wv.x, h[(o + 0) * kStride + p], t2);
            t2 = fmaf(wv.y, h[(o + 1) * kStride + p], t2);
            t2 = fmaf(wv.z, h[(o + 2) * kStride + p], t2);
            t2 = fmaf(wv.w, h[(o + 3) * kStride + p], t2);
          }
          const int64_t pix = p0 + p;
          if (pix < s.p) dx[pix * s.ci + c] = t2;
        }
      }
      __syncthreads();
    }
  }
  if (plan.acc_shared) {
    __syncthreads();
    for (int64_t j = threadIdx.x; j < np; j += blockDim.x) partial[j] = acc[j];
  }
}

// grad[j] = sum over blocks b, in order, of partial[b][j]
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ grad,
                    int blocks, int64_t np, int64_t stride) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= np) return;
  float t = 0.0f;
  for (int b = 0; b < blocks; ++b) t += partial[b * stride + j];
  grad[j] = t;
}

Shape make_shape(int n, int ci, int f, int cout, int64_t p) {
  Shape s;
  s.n = n;
  s.ci = ci;
  s.f = f;
  s.cout = cout;
  s.ci4 = (ci + 3) / 4 * 4;
  s.p = p;
  s.tiles = (p + kTile - 1) / kTile;
  return s;
}

bool valid(const Shape& s) {
  return s.n >= 1 && s.ci >= 1 && s.ci <= 8 && s.f % 8 == 0 && s.f >= 8 &&
         s.f <= 256 && s.cout >= 1 && s.cout <= 8 && s.p >= 1;
}

int fwd_smem(const Shape& s) {
  return static_cast<int>(sizeof(float) * (s.ci4 + 2 * s.f + s.cout) * kStride);
}

// The backward's memory layout for a grid of `blocks` blocks (no device
// query), with its shared-memory size set on the kernel.
cudaError_t layout(const Shape& s, int blocks, Plan* plan) {
  Plan pl;
  pl.blocks = blocks;
  pl.core_floats = static_cast<int64_t>(s.ci4 + s.cout) * kStride + 16 * kThreads;
  pl.act_floats = static_cast<int64_t>(s.n) * s.f * kStride;
  const int64_t np = num_params(s);
  const int64_t budget = kBudget / sizeof(float);
  int64_t used = pl.core_floats;
  pl.act_shared = used + pl.act_floats <= budget;
  if (pl.act_shared) used += pl.act_floats;
  pl.acc_shared = used + np <= budget;
  if (pl.acc_shared) used += np;
  pl.smem_bytes = static_cast<int>(used * sizeof(float));
  pl.work_floats =
      blocks * row_stride(s) + (pl.act_shared ? 0 : blocks * pl.act_floats);
  *plan = pl;
  return cudaFuncSetAttribute(trunk_bwd_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              pl.smem_bytes);
}

// The layout with the block count of a persistent grid on the current
// device: as many blocks as are resident at once, at most one per tile.
cudaError_t make_plan(const Shape& s, Plan* plan) {
  Plan pl;
  cudaError_t err = layout(s, 0, &pl);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, trunk_bwd_kernel, kThreads, pl.smem_bytes)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t want = static_cast<int64_t>(sms) * per_sm;
  return layout(s, static_cast<int>(want < s.tiles ? want : s.tiles), plan);
}

cudaError_t finish(cudaError_t err) {
  if (err != cudaSuccess) cudaGetLastError();  // do not leak into a later launch
  return err;
}

}  // namespace

// The backward's launch plan on the current device: out[0] = blocks of the
// persistent grid, out[1] = workspace floats the caller must allocate.
extern "C" int rf_cnn_train_plan(int n, int ci, int f, int cout, int64_t p,
                                 int64_t* out) {
  const Shape s = make_shape(n, ci, f, cout, p);
  if (!valid(s)) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  const cudaError_t err = make_plan(s, &pl);
  if (err != cudaSuccess) return static_cast<int>(finish(err));
  out[0] = pl.blocks;
  out[1] = pl.work_floats;
  return static_cast<int>(cudaSuccess);
}

// x [p, ci], w (flat, see above), pre [p, cout]; all f32 on the device.
extern "C" int rf_cnn_train_fwd(const float* x, const float* w, float* pre, int n,
                                int ci, int f, int cout, int64_t p,
                                cudaStream_t stream) {
  const Shape s = make_shape(n, ci, f, cout, p);
  if (!valid(s)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = fwd_smem(s);
  cudaError_t err = cudaFuncSetAttribute(
      trunk_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(finish(err));
  trunk_fwd_kernel<<<static_cast<unsigned>(s.tiles), kThreads, smem, stream>>>(s, x, w,
                                                                               pre);
  return static_cast<int>(cudaGetLastError());
}

// x [p, ci], g [p, cout], w (flat) -> grad (flat, same layout as w) and,
// when dx is not null, dx [p, ci].  work holds rf_cnn_train_plan's
// workspace floats and blocks is its block count, both queried once per
// (device, shape) by the caller; the sums' order depends on blocks, so the
// same blocks gives the same bits.
extern "C" int rf_cnn_train_bwd(const float* x, const float* g, const float* w,
                                float* grad, float* dx, float* work, int n, int ci,
                                int f, int cout, int64_t p, int blocks,
                                cudaStream_t stream) {
  const Shape s = make_shape(n, ci, f, cout, p);
  if (!valid(s) || blocks < 1 || blocks > s.tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  cudaError_t err = layout(s, blocks, &pl);
  if (err != cudaSuccess) return static_cast<int>(finish(err));
  trunk_bwd_kernel<<<pl.blocks, kThreads, pl.smem_bytes, stream>>>(s, pl, x, g, w, dx,
                                                                   work);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t np = num_params(s);
  sum_partials_kernel<<<static_cast<unsigned>((np + kThreads - 1) / kThreads), kThreads,
                        0, stream>>>(work, grad, pl.blocks, np, row_stride(s));
  return static_cast<int>(cudaGetLastError());
}
