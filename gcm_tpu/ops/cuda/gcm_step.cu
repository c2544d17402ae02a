// One-pass grid-characteristic time step for the 3D isotropic elastic model
// (order 2, f32) on NVIDIA Hopper, called from JAX through the FFI.
//
// Semantics are those of gcm_tpu.solver.gcm.step with axes (0,1,2) or
// (2,1,0): three characteristic sweeps, edge-clamped Lagrange stencils,
// characteristic border corrections and zero-speed invariants. The plain
// jnp step is the reference; gcm_tpu/ops/hopper_step.py wraps this file.
//
// Layout: u[9][nx][ny][nz] (z contiguous); materials cp, cs, rho, kappa as
// [nx][ny][nz]; impedances are rho*c, as MaterialFields builds them.
//
// Each block owns a (TY-2) x (TZ-2) tile of the (y, z) plane plus a
// one-cell halo, and marches along x over a chunk of planes. Every thread
// owns one (y, z) column of the haloed tile and keeps the x-ring of three
// planes in registers:
//   order (0,1,2): the ring holds raw state; the x sweep runs on the whole
//     haloed tile, then y and z run in shared memory, then one store;
//   order (2,1,0): each incoming plane is swept along z then y in shared
//     memory; the ring holds zy-swept planes and the x sweep comes last.
// State and materials are read once per plane and the result written once:
// 9 + 4 floats in, 9 out per point, plus the tile halo.
//
// Build (see hopper_step.build_command):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I <jax.ffi.include_dir()> gcm_step.cu

#include <cstdint>

#ifndef GCM_EMULATE
#include <cuda_runtime.h>
#include "xla/ffi/api/ffi.h"
#endif

namespace gcm {

constexpr int TY = 8;          // haloed tile extent along y
constexpr int TZ = 32;         // haloed tile extent along z (one warp)
constexpr int NT = TY * TZ;    // threads per block
constexpr int NC = 9;          // state components
constexpr int XCHUNK = 64;     // most x planes per block
constexpr int MIN_XCHUNK = 8;  // fewest x planes per block
constexpr int BLOCKS_PER_SM = 8;  // blocks aimed at per multiprocessor

// border kinds, as gcm_tpu.ops.hopper_step.BORDER_CODES
constexpr int B_NONE = 0, B_ABSORBING = 1, B_FREE = 2, B_FORCE = 3,
              B_VELOCITY = 4;

struct Params {
  int nx, ny, nz;
  int xchunk;
  float dtoh[3];        // dt / h per axis
  int kind[6];          // face 2*axis + side
  float val[6][3];      // face value per traction axis
};

// component index of sigma_ij (elastic3d: vx vy vz sxx sxy sxz syy syz szz)
__device__ __host__ constexpr int sig(int i, int j) {
  return i > j ? sig(j, i)
               : (i == 0 ? 3 + j : (i == 1 ? 5 + j : 8));
}

// One characteristic sweep along axis A at one node. um/u0/up: state at
// the clamped neighbours i-1, i, i+1; gi/n: index and extent along A.
template <int A>
__device__ __forceinline__ void sweep_point(
    const float* um, const float* u0, const float* up, float cp, float cs,
    float rho, float kap, const Params& P, int gi, int n, float* out) {
  constexpr int B1 = (A + 1) % 3 < (A + 2) % 3 ? (A + 1) % 3 : (A + 2) % 3;
  constexpr int B2 = (A + 1) % 3 < (A + 2) % 3 ? (A + 2) % 3 : (A + 1) % 3;
  // pair k: (sigma, vel, traction axis); k = 0 is the P pair
  const int SIG[3] = {sig(A, A), sig(A, B1), sig(A, B2)};
  const int VEL[3] = {A, B1, B2};
  const float dtoh = P.dtoh[A];
  const int klo = P.kind[2 * A], khi = P.kind[2 * A + 1];
#pragma unroll
  for (int c = 0; c < NC; ++c) out[c] = u0[c];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float c = k == 0 ? cp : cs;
    const float z = rho * c;
    const float t = c * dtoh;
    const float w0 = 0.5f * t * (t - 1.0f);
    const float w1 = 1.0f - t * t;
    const float w2 = 0.5f * t * (t + 1.0f);
    const int s = SIG[k], v = VEL[k];
    const float ap = w0 * um[s] + w1 * u0[s] + w2 * up[s];
    const float bp = w0 * um[v] + w1 * u0[v] + w2 * up[v];
    const float am = w0 * up[s] + w1 * u0[s] + w2 * um[s];
    const float bm = w0 * up[v] + w1 * u0[v] + w2 * um[v];
    float wl = ap + z * bp;
    float wr = am - z * bm;
    if (gi == 0 && klo != B_NONE) {
      const float val = P.val[2 * A][VEL[k]];
      wr = klo == B_ABSORBING ? 0.0f
         : klo == B_FREE      ? -wl
         : klo == B_FORCE     ? 2.0f * val - wl
                              : wl - 2.0f * z * val;
    }
    if (gi == n - 1 && khi != B_NONE) {
      const float val = P.val[2 * A + 1][VEL[k]];
      wl = khi == B_ABSORBING ? 0.0f
         : khi == B_FREE      ? -wr
         : khi == B_FORCE     ? 2.0f * val - wr
                              : wr + 2.0f * z * val;
    }
    out[s] = 0.5f * (wl + wr);
    out[v] = z > 0.0f ? (wl - wr) / (2.0f * fmaxf(z, 1e-30f)) : u0[v];
  }
  // zero-speed invariants: sigma_bb += kappa * (sigma_aa_new - sigma_aa_old)
  const float d = out[sig(A, A)] - u0[sig(A, A)];
  out[sig(B1, B1)] = u0[sig(B1, B1)] + kap * d;
  out[sig(B2, B2)] = u0[sig(B2, B2)] + kap * d;
}

__device__ __forceinline__ int clampi(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

struct Mat { float cp, cs, rho, kap; };

template <bool FWD>
__global__ void __launch_bounds__(NT, 1)
step_kernel(const float* __restrict__ u, const float* __restrict__ cp,
            const float* __restrict__ cs, const float* __restrict__ rho,
            const float* __restrict__ kap, float* __restrict__ out,
            Params P) {
  __shared__ float sa[NC][TY][TZ];
  __shared__ float sb[NC][TY][TZ];
  const int ty = threadIdx.x / TZ, tz = threadIdx.x % TZ;
  const int yi = blockIdx.y * (TY - 2) - 1 + ty;   // unclamped y
  const int zi = blockIdx.x * (TZ - 2) - 1 + tz;   // unclamped z
  const int gy = clampi(yi, P.ny), gz = clampi(zi, P.nz);
  const bool inner = ty >= 1 && ty <= TY - 2 && tz >= 1 && tz <= TZ - 2;
  const bool store = inner && yi < P.ny && zi < P.nz;
  const int64_t S = (int64_t)P.ny * P.nz;       // plane stride
  const int64_t C = (int64_t)P.nx * S;          // component stride
  const int64_t col = (int64_t)gy * P.nz + gz;
  const int xs = blockIdx.z * P.xchunk;
  const int xe = xs + P.xchunk < P.nx ? xs + P.xchunk : P.nx;

  auto load = [&](int x, float* r) {
    const int64_t o = (int64_t)clampi(x, P.nx) * S + col;
#pragma unroll
    for (int c = 0; c < NC; ++c) r[c] = u[c * C + o];
  };
  auto load_mat = [&](int x) {
    const int64_t o = (int64_t)clampi(x, P.nx) * S + col;
    return Mat{cp[o], cs[o], rho[o], kap[o]};
  };

  if (FWD) {
    float rm[NC], r0[NC], rp[NC], nxt[NC], v[NC], m_[NC], p_[NC];
    load(xs - 1, rm);
    load(xs, r0);
    load(xs + 1, rp);
    for (int x = xs; x < xe; ++x) {
      const Mat m = load_mat(x);
      load(x + 2, nxt);                       // prefetch the next plane
      sweep_point<0>(rm, r0, rp, m.cp, m.cs, m.rho, m.kap, P, x, P.nx, v);
#pragma unroll
      for (int c = 0; c < NC; ++c) sa[c][ty][tz] = v[c];
      __syncthreads();
      if (ty >= 1 && ty <= TY - 2) {
        float w[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          m_[c] = sa[c][ty - 1][tz];
          p_[c] = sa[c][ty + 1][tz];
        }
        sweep_point<1>(m_, v, p_, m.cp, m.cs, m.rho, m.kap, P, yi, P.ny, w);
#pragma unroll
        for (int c = 0; c < NC; ++c) sb[c][ty][tz] = w[c];
      }
      __syncthreads();
      if (inner) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          m_[c] = sb[c][ty][tz - 1];
          v[c] = sb[c][ty][tz];
          p_[c] = sb[c][ty][tz + 1];
        }
        float o[NC];
        sweep_point<2>(m_, v, p_, m.cp, m.cs, m.rho, m.kap, P, zi, P.nz, o);
        if (store) {
          const int64_t off = (int64_t)x * S + col;
#pragma unroll
          for (int c = 0; c < NC; ++c) out[c * C + off] = o[c];
        }
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        rm[c] = r0[c];
        r0[c] = rp[c];
        rp[c] = nxt[c];
      }
    }
  } else {
    // zy-swept ring (valid on inner threads) and the mats of its planes
    float qm[NC], q0[NC], qp[NC], r[NC], m_[NC], p_[NC];
    Mat mq0{}, mqp{};
    // sweep plane x along z then y; result lands in q (inner threads)
    auto zy_plane = [&](int x, float* q, Mat& mat) {
      load(x, r);
      mat = load_mat(x);
#pragma unroll
      for (int c = 0; c < NC; ++c) sa[c][ty][tz] = r[c];
      __syncthreads();
      if (tz >= 1 && tz <= TZ - 2) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          m_[c] = sa[c][ty][tz - 1];
          p_[c] = sa[c][ty][tz + 1];
        }
        float o[NC];
        sweep_point<2>(m_, r, p_, mat.cp, mat.cs, mat.rho, mat.kap, P, zi,
                       P.nz, o);
#pragma unroll
        for (int c = 0; c < NC; ++c) sb[c][ty][tz] = o[c];
      }
      __syncthreads();
      if (inner) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          m_[c] = sb[c][ty - 1][tz];
          r[c] = sb[c][ty][tz];
          p_[c] = sb[c][ty + 1][tz];
        }
        sweep_point<1>(m_, r, p_, mat.cp, mat.cs, mat.rho, mat.kap, P, yi,
                       P.ny, q);
      }
      // the next call rewrites sa before anyone reads sb again, and sb
      // only after the sync that follows that write
    };
    Mat mtmp;
    zy_plane(xs - 1, qm, mtmp);
    zy_plane(xs, q0, mq0);
    for (int x = xs; x < xe; ++x) {
      zy_plane(x + 1, qp, mqp);
      if (inner) {
        float o[NC];
        sweep_point<0>(qm, q0, qp, mq0.cp, mq0.cs, mq0.rho, mq0.kap, P, x,
                       P.nx, o);
        if (store) {
          const int64_t off = (int64_t)x * S + col;
#pragma unroll
          for (int c = 0; c < NC; ++c) out[c * C + off] = o[c];
        }
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        qm[c] = q0[c];
        q0[c] = qp[c];
      }
      mq0 = mqp;
    }
  }
}

// x planes per block: short chunks when the (y, z) tiles alone give fewer
// than BLOCKS_PER_SM blocks for each of the card's `sms` multiprocessors
// (1056 blocks on an H100 SXM's 132; each chunk re-reads, or in order
// (2,1,0) re-sweeps, two planes), at most XCHUNK.
inline int pick_xchunk(int nx, int ny, int nz, int sms) {
  const long tiles = (long)((nz + TZ - 3) / (TZ - 2)) * ((ny + TY - 3) / (TY - 2));
  const long target = (long)BLOCKS_PER_SM * sms;
  const long chunks = (target + tiles - 1) / tiles;
  long xc = (nx + chunks - 1) / chunks;
  xc = xc < MIN_XCHUNK ? MIN_XCHUNK : (xc > XCHUNK ? XCHUNK : xc);
  return (int)xc;
}

// Enqueue one step; returns 0 or a CUDA error code.
inline int launch(const float* u, const float* cp, const float* cs,
                  const float* rho, const float* kap, float* out,
                  const Params& P, bool reverse
#ifndef GCM_EMULATE
                  , cudaStream_t stream
#endif
                  ) {
  dim3 grid((P.nz + TZ - 3) / (TZ - 2), (P.ny + TY - 3) / (TY - 2),
            (P.nx + P.xchunk - 1) / P.xchunk);
#ifdef GCM_EMULATE
  if (reverse)
    emu_launch(grid, NT, [&] { step_kernel<false>(u, cp, cs, rho, kap, out, P); });
  else
    emu_launch(grid, NT, [&] { step_kernel<true>(u, cp, cs, rho, kap, out, P); });
  return 0;
#else
  if (reverse)
    step_kernel<false><<<grid, NT, 0, stream>>>(u, cp, cs, rho, kap, out, P);
  else
    step_kernel<true><<<grid, NT, 0, stream>>>(u, cp, cs, rho, kap, out, P);
  return (int)cudaGetLastError();
#endif
}

inline bool make_params(int nx, int ny, int nz, const float* dtoh, int ndtoh,
                        const int32_t* kinds, int nkinds, const float* vals,
                        int nvals, int xchunk, Params* P) {
  if (ndtoh != 3 || nkinds != 6 || nvals != 18 || xchunk < 1) return false;
  P->nx = nx; P->ny = ny; P->nz = nz; P->xchunk = xchunk;
  for (int a = 0; a < 3; ++a) P->dtoh[a] = dtoh[a];
  for (int f = 0; f < 6; ++f) {
    if (kinds[f] < B_NONE || kinds[f] > B_VELOCITY) return false;
    P->kind[f] = kinds[f];
    for (int t = 0; t < 3; ++t) P->val[f][t] = vals[3 * f + t];
  }
  return true;
}

}  // namespace gcm

#ifdef GCM_EMULATE

// CPU build of the same kernel (tests/cuda_emulate.h supplies the CUDA
// names): one std::thread per CUDA thread, blocks in sequence.
extern "C" int gcm_step_emulated(const float* u, const float* cp,
                                 const float* cs, const float* rho,
                                 const float* kap, float* out, int nx, int ny,
                                 int nz, const float* dtoh,
                                 const int32_t* kinds, const float* vals,
                                 int reverse, int xchunk) {
  gcm::Params P;
  if (!gcm::make_params(nx, ny, nz, dtoh, 3, kinds, 6, vals, 18, xchunk, &P))
    return -1;
  return gcm::launch(u, cp, cs, rho, kap, out, P, reverse != 0);
}

extern "C" int gcm_pick_xchunk(int nx, int ny, int nz, int sms) {
  return gcm::pick_xchunk(nx, ny, nz, sms);
}

#else

namespace ffi = xla::ffi;

static ffi::Error GcmStepImpl(cudaStream_t stream, int32_t device,
                              ffi::Buffer<ffi::F32> u,
                              ffi::Buffer<ffi::F32> cp,
                              ffi::Buffer<ffi::F32> cs,
                              ffi::Buffer<ffi::F32> rho,
                              ffi::Buffer<ffi::F32> kap,
                              ffi::ResultBuffer<ffi::F32> out,
                              ffi::Span<const float> dtoh,
                              ffi::Span<const int32_t> kinds,
                              ffi::Span<const float> vals,
                              int32_t reverse) {
  auto d = u.dimensions();
  auto m = cp.dimensions();
  if (d.size() != 4 || d[0] != gcm::NC || m.size() != 3 || m[0] != d[1] ||
      m[1] != d[2] || m[2] != d[3])
    return ffi::Error::InvalidArgument(
        "gcm_step: expected u[9,nx,ny,nz] and materials [nx,ny,nz]");
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return ffi::Error::Internal("gcm_step: no multiprocessor count");
  gcm::Params P;
  if (!gcm::make_params((int)d[1], (int)d[2], (int)d[3], dtoh.begin(),
                        (int)dtoh.size(), kinds.begin(), (int)kinds.size(),
                        vals.begin(), (int)vals.size(),
                        gcm::pick_xchunk((int)d[1], (int)d[2], (int)d[3], sms),
                        &P))
    return ffi::Error::InvalidArgument("gcm_step: bad attributes");
  int err = gcm::launch(u.typed_data(), cp.typed_data(), cs.typed_data(),
                        rho.typed_data(), kap.typed_data(),
                        out->typed_data(), P, reverse != 0, stream);
  if (err != 0)
    return ffi::Error::Internal(
        cudaGetErrorString(static_cast<cudaError_t>(err)));
  return ffi::Error::Success();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    GcmStep, GcmStepImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Ctx<ffi::DeviceOrdinal>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Attr<ffi::Span<const float>>("dtoh")
        .Attr<ffi::Span<const int32_t>>("kinds")
        .Attr<ffi::Span<const float>>("vals")
        .Attr<int32_t>("reverse"));

#endif
