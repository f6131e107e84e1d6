// Optimized CPU pruning + linear-time branch gradient: the honest
// BEAGLE-CPU stand-in for bench.py's vs_baseline denominator.
//
// The reference delegates this exact workload to BEAGLE's CPU backend
// (SSE/AVX vectorized update-partials / update-pre-partials /
// edge-derivatives; /root/reference/src/fat_beagle.cpp:50-70,119-175).
// BEAGLE itself is not available in this environment, so this file
// implements the same computation pattern, vectorized the same way
// (pattern-major inner loops the compiler lowers to AVX-512 on this
// host), threaded over trees like FatBeagleParallelize
// (/root/reference/src/fat_beagle.hpp:119-149). It is deliberately a
// STRONG baseline: skip-inert-children, E-buffer reuse between the
// post/pre passes, fused gradient accumulation.
//
// Schedule conventions match libsbn_tpu/ops/schedule.py: leaves are
// taxon ids, internals postorder-linear (step s writes node L+s, root
// last), the `ones` slot (index node_count) pads child lists and is
// numerically inert.
//
// Build: make -C native cpu_baseline  (g++ -O3 -march=native, with -fopenmp
// where the compiler has the OpenMP runtime)

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// JC69 transition matrix: P(b)[i][j] = 0.25 + 0.75 e^{-4b/3} (i==j)
//                                    = 0.25 - 0.25 e^{-4b/3} (i!=j)
// and dP = Q P with Q[i][j] = -1 (i==j), 1/3 (i!=j) (normalized JC69,
// matching libsbn_tpu/ops/substitution.py and gp_engine.hpp:144-155).
template <typename T>
void jc69_p_and_dp(double bl, T* P, T* dP) {
  const double e = std::exp(-4.0 / 3.0 * bl);
  const double diag = 0.25 + 0.75 * e;
  const double off = 0.25 - 0.25 * e;
  const double ddiag = -e;            // d(diag)/db
  const double doff = e / 3.0;        // d(off)/db
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      P[4 * i + j] = static_cast<T>(i == j ? diag : off);
      dP[4 * i + j] = static_cast<T>(i == j ? ddiag : doff);
    }
}

// dst[i][p] = sum_j M[i][j] src[j][p]  (4 x Sp) — the BEAGLE
// update-partials inner contraction, pattern-vectorized.
template <typename T>
inline void matvec4(const T* __restrict__ M, const T* __restrict__ src,
                    T* __restrict__ dst, int Sp) {
  for (int i = 0; i < 4; ++i) {
    const T m0 = M[4 * i + 0], m1 = M[4 * i + 1], m2 = M[4 * i + 2],
            m3 = M[4 * i + 3];
    const T* s0 = src;
    const T* s1 = src + Sp;
    const T* s2 = src + 2 * Sp;
    const T* s3 = src + 3 * Sp;
    T* d = dst + i * Sp;
#pragma omp simd
    for (int p = 0; p < Sp; ++p)
      d[p] = m0 * s0[p] + m1 * s1[p] + m2 * s2[p] + m3 * s3[p];
  }
}

template <typename T>
struct Scratch {
  std::vector<T> part;   // (N+1, 4, Sp) partials; ones slot all-ones
  std::vector<T> evolved;  // (N+1, 4, Sp) E[n] = P_n @ part[n]
  std::vector<T> upper;  // (N, 4, Sp) U[n]
  std::vector<T> anode;  // (4, Sp) A[n] staging
  std::vector<T> tmp;    // (4, Sp)
  std::vector<T> sitelik;  // (Sp,)
  Scratch(int N, int Sp)
      : part((size_t)(N + 1) * 4 * Sp),
        evolved((size_t)(N + 1) * 4 * Sp, T(1)),
        upper((size_t)N * 4 * Sp),
        anode((size_t)4 * Sp),
        tmp((size_t)4 * Sp),
        sitelik(Sp) {}
};

// One tree: postorder partials, root LL, preorder uppers, per-edge
// gradients (the beagleUpdatePartials / beagleUpdatePrePartials /
// beagleCalculateEdgeDerivatives trio, fat_beagle.cpp:139-175).
template <typename T>
double eval_tree(const int32_t* post_children,  // (n_internal, 3)
                 const int32_t* up_node, const int32_t* up_parent,
                 const int32_t* up_sibs,  // (n_up,), (n_up,), (n_up, 2)
                 const double* bl,        // (N+1,) by node id
                 const T* tips,           // (L, 4, Sp)
                 const T* weights,        // (Sp,)
                 int L, int N, int n_up, int Sp, Scratch<T>& sc,
                 double* grad_out /* (N,) by node id */) {
  const int ones = N;
  const size_t plane = (size_t)4 * Sp;
  // Leaves + ones slot.
  std::memcpy(sc.part.data(), tips, (size_t)L * plane * sizeof(T));
  for (size_t k = 0; k < plane; ++k) sc.part[(size_t)ones * plane + k] = T(1);

  std::vector<T> P((size_t)(N + 1) * 16), dP((size_t)(N + 1) * 16);
  for (int n = 0; n <= N; ++n)
    jc69_p_and_dp(bl[n], &P[16 * n], &dP[16 * n]);

  // Postorder: E[c] = P_c part[c]; part[node] = prod_children E[c].
  const int n_internal = N - L;
  for (int s = 0; s < n_internal; ++s) {
    const int node = L + s;
    T* dst = &sc.part[(size_t)node * plane];
    bool first = true;
    for (int k = 0; k < 3; ++k) {
      const int c = post_children[3 * s + k];
      if (c == ones) continue;
      T* E = &sc.evolved[(size_t)c * plane];
      matvec4(&P[16 * c], &sc.part[(size_t)c * plane], E, Sp);
      if (first) {
        std::memcpy(dst, E, plane * sizeof(T));
        first = false;
      } else {
#pragma omp simd
        for (int k2 = 0; k2 < (int)plane; ++k2) dst[k2] *= E[k2];
      }
    }
  }

  // Root log-likelihood (uniform JC69 stationary freqs).
  const int root = N - 1;
  const T* rp = &sc.part[(size_t)root * plane];
  double ll = 0.0;
#pragma omp simd
  for (int p = 0; p < Sp; ++p)
    sc.sitelik[p] = T(0.25) * (rp[p] + rp[Sp + p] + rp[2 * Sp + p] +
                               rp[3 * Sp + p]);
  for (int p = 0; p < Sp; ++p)
    if (weights[p] != T(0))
      ll += (double)weights[p] * std::log((double)sc.sitelik[p]);

  if (grad_out == nullptr) return ll;  // LL-only mode (bench config 2)

  // Preorder uppers + fused edge gradients.
  T* Ur = &sc.upper[(size_t)root * plane];
  for (int i = 0; i < 4; ++i)
#pragma omp simd
    for (int p = 0; p < Sp; ++p) Ur[i * Sp + p] = T(0.25);

  for (int t = 0; t < n_up; ++t) {
    const int node = up_node[t];
    const int parent = up_parent[t];
    const int s1 = up_sibs[2 * t], s2 = up_sibs[2 * t + 1];
    const T* U = &sc.upper[(size_t)parent * plane];
    T* A = sc.anode.data();
    const T* E1 = (s1 == ones) ? nullptr : &sc.evolved[(size_t)s1 * plane];
    const T* E2 = (s2 == ones) ? nullptr : &sc.evolved[(size_t)s2 * plane];
#pragma omp simd
    for (int k = 0; k < (int)plane; ++k) {
      T v = U[k];
      if (E1) v *= E1[k];
      if (E2) v *= E2[k];
      A[k] = v;
    }
    // Gradient: sum_p w/sitelik * sum_i A[i][p] (Q E[node])[i][p],
    // where Q E = dP part (dP = Q P, E = P part).
    matvec4(&dP[16 * node], &sc.part[(size_t)node * plane], sc.tmp.data(),
            Sp);
    double g = 0.0;
    const T* QE = sc.tmp.data();
#pragma omp simd reduction(+ : g)
    for (int p = 0; p < Sp; ++p) {
      const T dot = A[p] * QE[p] + A[Sp + p] * QE[Sp + p] +
                    A[2 * Sp + p] * QE[2 * Sp + p] +
                    A[3 * Sp + p] * QE[3 * Sp + p];
      g += (double)(weights[p] * dot / sc.sitelik[p]);
    }
    grad_out[node] = g;
    // U[node] = P_node^T A (only needed for internal nodes).
    if (node >= L) {
      T Pt[16];
      const T* Pn = &P[16 * node];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) Pt[4 * i + j] = Pn[4 * j + i];
      matvec4(Pt, A, &sc.upper[(size_t)node * plane], Sp);
    }
  }
  return ll;
}

template <typename T>
void run_batch(const int32_t* post_children,  // (n_trees, n_internal, 3)
               const int32_t* up_node,        // (n_trees, n_up)
               const int32_t* up_parent,      // (n_trees, n_up)
               const int32_t* up_sibs,        // (n_trees, n_up, 2)
               const double* bl, const double* tips64,
               const double* weights64, int32_t n_trees, int32_t L,
               int32_t N, int32_t n_up, int32_t S, int32_t threads,
               double* out_ll, double* out_grad) {
  // Pad patterns to the SIMD width.
  const int W = 64 / (int)sizeof(T);
  const int Sp = (S + W - 1) / W * W;
  std::vector<T> tips((size_t)L * 4 * Sp, T(1));
  for (int l = 0; l < L; ++l)
    for (int i = 0; i < 4; ++i)
      for (int p = 0; p < S; ++p)
        tips[((size_t)l * 4 + i) * Sp + p] =
            static_cast<T>(tips64[((size_t)l * 4 + i) * S + p]);
  std::vector<T> weights(Sp, T(0));
  for (int p = 0; p < S; ++p) weights[p] = static_cast<T>(weights64[p]);

  const int n_internal = N - L;
#ifdef _OPENMP
  if (threads > 0) omp_set_num_threads(threads);
#pragma omp parallel
#endif
  {
    Scratch<T> sc(N, Sp);
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
    for (int32_t t = 0; t < n_trees; ++t) {
      double* g = out_grad ? out_grad + (size_t)t * N : nullptr;
      if (g) std::memset(g, 0, (size_t)N * sizeof(double));
      out_ll[t] = eval_tree<T>(
          post_children + (size_t)t * n_internal * 3,
          up_node + (size_t)t * n_up, up_parent + (size_t)t * n_up,
          up_sibs + (size_t)t * n_up * 2, bl + (size_t)t * (N + 1),
          tips.data(), weights.data(), L, N, n_up, Sp, sc, g);
    }
  }
}

}  // namespace

extern "C" {

// Evaluate LL + branch gradient for n_trees trees. All schedule arrays
// are per-tree (same shapes across trees — same taxon count): see
// run_batch signature. dtype_bits selects float (32) or double (64).
// Passing out_grad == NULL computes log-likelihoods only (the batched-
// likelihood bench config skips the two-pass gradient).
void lsbn_cpu_baseline_eval(const int32_t* post_children,
                            const int32_t* up_node, const int32_t* up_parent,
                            const int32_t* up_sibs, const double* bl,
                            const double* tips, const double* weights,
                            int32_t n_trees, int32_t L, int32_t N,
                            int32_t n_up, int32_t S, int32_t threads,
                            int32_t dtype_bits, double* out_ll,
                            double* out_grad) {
  if (dtype_bits == 32)
    run_batch<float>(post_children, up_node, up_parent, up_sibs, bl, tips,
                     weights, n_trees, L, N, n_up, S, threads, out_ll,
                     out_grad);
  else
    run_batch<double>(post_children, up_node, up_parent, up_sibs, bl, tips,
                      weights, n_trees, L, N, n_up, S, threads, out_ll,
                      out_grad);
}


// K-category log-likelihood-only evaluation with caller-precomputed
// transition matrices (any substitution/site model — GTR, Weibull rates —
// becomes a P tensor on the Python side; the native side is the pruning
// recursion itself, the BEAGLE-CPU role for the batched-likelihood bench
// config). P: (n_trees, N+1, K, 4, 4); tips: (L, 4, S); props: (K,);
// freqs: (4,). out_ll: (n_trees,).
void lsbn_cpu_baseline_eval_pk(const int32_t* post_children, const double* P,
                               const double* tips64, const double* weights64,
                               const double* props, const double* freqs,
                               int32_t n_trees, int32_t L, int32_t N,
                               int32_t K, int32_t S, int32_t threads,
                               double* out_ll) {
  using T = double;
  const int W = 64 / (int)sizeof(T);
  const int Sp = (S + W - 1) / W * W;
  const size_t plane = (size_t)4 * Sp;
  std::vector<T> tips((size_t)L * plane, T(1));
  for (int l = 0; l < L; ++l)
    for (int i = 0; i < 4; ++i)
      for (int p = 0; p < S; ++p)
        tips[(size_t)l * plane + (size_t)i * Sp + p] =
            tips64[((size_t)l * 4 + i) * S + p];
  std::vector<T> weights(Sp, T(0));
  for (int p = 0; p < S; ++p) weights[p] = weights64[p];
  const int n_internal = N - L;
  const int ones = N;
#ifdef _OPENMP
  if (threads > 0) omp_set_num_threads(threads);
#pragma omp parallel
#endif
  {
    std::vector<T> part((size_t)(N + 1) * plane, T(1));
    std::vector<T> evolved(plane);
    std::vector<T> site(Sp);
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
    for (int32_t t = 0; t < n_trees; ++t) {
      std::fill(site.begin(), site.end(), T(0));
      for (int k = 0; k < K; ++k) {
        std::memcpy(part.data(), tips.data(),
                    (size_t)L * plane * sizeof(T));
        for (size_t q = 0; q < plane; ++q)
          part[(size_t)ones * plane + q] = T(1);
        for (int s = 0; s < n_internal; ++s) {
          const int node = L + s;
          T* dst = &part[(size_t)node * plane];
          bool first = true;
          for (int c3 = 0; c3 < 3; ++c3) {
            const int c = post_children[((size_t)t * n_internal + s) * 3 + c3];
            if (c == ones) continue;
            const double* Pm =
                P + ((((size_t)t * (N + 1) + c) * K + k) * 16);
            T Pc[16];
            for (int q = 0; q < 16; ++q) Pc[q] = Pm[q];
            matvec4(Pc, &part[(size_t)c * plane], evolved.data(), Sp);
            if (first) {
              std::memcpy(dst, evolved.data(), plane * sizeof(T));
              first = false;
            } else {
#pragma omp simd
              for (int q = 0; q < (int)plane; ++q) dst[q] *= evolved[q];
            }
          }
        }
        const T* rp = &part[(size_t)(N - 1) * plane];
#pragma omp simd
        for (int p = 0; p < Sp; ++p)
          site[p] += (T)props[k] *
                     ((T)freqs[0] * rp[p] + (T)freqs[1] * rp[Sp + p] +
                      (T)freqs[2] * rp[2 * Sp + p] +
                      (T)freqs[3] * rp[3 * Sp + p]);
      }
      double ll = 0.0;
      for (int p = 0; p < Sp; ++p)
        if (weights[p] != T(0)) ll += (double)weights[p] * std::log((double)site[p]);
      out_ll[t] = ll;
    }
  }
}

// Host threads the batch loops use: OpenMP's count, or 1 when the
// library was built without the OpenMP runtime.
int lsbn_cpu_baseline_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
