// The parts of the whole-scan partitioned convolution (streamstep.cu: TPU
// kernels stream_steps_fused{,_tv,_batched,_batched_tv} and
// stream_steps_fused_split{,_tv}) around its two transform steps, and the
// timeline MACs that the sliding MACs (slidemac.cu: chunk_mac,
// macflow_lti{,_batched}, macflow_tv{,_batched}) run too. streamstep.cu
// passes the transform steps (how a block becomes its frame spectra and how
// an accumulator becomes its output block) to run_scan / run_tv_scan as
// functors.
//
// A scan of nb blocks of C channels (pts = bins): per channel c a frame
// timeline T_c (nparts + nb rows of [re | im], 2*bins wide) whose rows
// [0, nparts) are the initial window and row nparts + t the frames of block
// t; block t's window is rows [t+1, t+1+nparts). The MAC
//   acc[c, t, k] = sum_q T_c[t+1+q, k] (*) h[q, k]
// (bin 0, the packed (DC/2, Nyq/2) pair, componentwise and times b0) is
// written to aext_c row t+1, whose rows 0 and nb+1 are zero, so the inverse
// step can read [acc[t-1] | acc[t]] for the overlap-add. In the TV scan h
// is a second timeline HT_c of nparts-1+nb rows: row s+nparts-1 holds the
// coefficient frame of block s, rows [0, nparts-1) the initial ring at
// pseudo-times s = -(nparts-1)..-1 (ring slot (wp2_c - s) mod nparts), and
// block t pairs partition q with row t - ((t - wp2_c + q) mod nparts) +
// nparts - 1. The final window is T_c rows [nb, nb+nparts), the final ring
// the same gather at t = nb-1.
//
// The scan's MAC (mac_tile_kernel). Each (channel, block, partition, bin)
// costs one complex multiply-add (four FMAs) against one h element and one
// timeline element, so the MAC is bound by its loads unless every loaded
// element feeds many FMAs. One thread owns one bin and TT consecutive
// outputs (8 or 16) and slides their window rows through registers (each
// timeline element serves TT outputs); a CTA stacks G such warps over the
// same 32 bins and G * TT consecutive outputs of one channel and streams
// the partitions in stages of Q: each stage's h rows and its Q new timeline
// rows land in shared memory by cp.async while the CTA multiplies the
// previous stage, the timeline rows in a ring that keeps the G * TT - 1
// rows the next stage shares. Each h and timeline element then crosses L2
// once per CTA, not once per thread, and the FMAs read (re, im) pairs from
// shared memory. A block of TT partitions whose ring rows do not wrap (and,
// TV, whose outputs all read one staged row) runs without index arithmetic.
// The sum over q of every output runs in ascending q, as the twins' does.
// The TV MAC stages, for each partition, the one or two h rows that the
// CTA's outputs read (the row changes only where (t - wp2 + q) mod nparts
// wraps, at most once in G * TT <= nparts outputs). The plan (G, TT, Q)
// comes from the caller (ops/cuda/streamstep.py mac_plan); the TV scan
// below MAC_TT partitions keeps the per-thread MAC (mac_tv_kernel). The
// tile reads and writes through a MacIO (split re / im planes at any row
// and channel strides), so the LTI sliding MAC runs the same kernel on its
// (C, rows, bins) timelines and (C, nout, bins) outputs.

#pragma once

#include "launch.cuh"

namespace {

constexpr int MAC_TT = 8;          // output rows per MAC thread
constexpr int MAC_THREADS = 128;   // bins per MAC block
constexpr int ROW_THREADS = 128;   // threads a CTA of the ring gathers

__device__ __forceinline__ int pmod(int a, int n) {
    const int r = a % n;
    return r < 0 ? r + n : r;
}

// Sizes of one scan and the per-channel strides of its buffers: channel c
// of a buffer starts at c * (its stride). Blocks and outputs are (nb, C,
// pts): block t of channel c is row t*C + c.
struct Scan {
    int nb, C, nparts, bins;   // bins == pts
    __host__ __device__ size_t b2() const { return 2 * static_cast<size_t>(bins); }
    // window / IR / ring planes (nparts, bins)
    __host__ __device__ size_t plane() const { return static_cast<size_t>(nparts) * bins; }
    // rows of 2b: frame timeline (nparts+nb), coefficient timeline
    // (nparts-1+nb), MAC output with a zero row before and after (nb+2)
    __host__ __device__ size_t tl_rows() const { return static_cast<size_t>(nparts) + nb; }
    __host__ __device__ size_t ht_rows() const { return static_cast<size_t>(nparts) - 1 + nb; }
    __host__ __device__ size_t ax_rows() const { return static_cast<size_t>(nb) + 2; }
    __host__ __device__ size_t tl() const { return tl_rows() * b2(); }
    __host__ __device__ size_t ht() const { return ht_rows() * b2(); }
    __host__ __device__ size_t ax() const { return ax_rows() * b2(); }
};

// How a MAC thread finds the h row of each of its MAC_TT outputs at
// partition q. H_LTI (the tiled MAC and mac_rows_q): the IR ring, row q
// for every output. H_TV: the
// coefficient timeline, row t - ((t - wp2_0 + q) mod nparts) + nparts - 1
// for output t, any nparts. H_TV_PAIR (nparts >= MAC_TT): with
// m0 = (t0 - wp2_0 + q) mod nparts, outputs t0+j with m0 + j < nparts read
// row ra = t0 - m0 + nparts - 1 and the others (past the one wrap) row
// ra + nparts, so two row loads per q serve all MAC_TT outputs.
enum HMode { H_LTI, H_TV, H_TV_PAIR };

// One channel's MAC_TT outputs t0.. of bin k (H_TV or H_TV_PAIR):
//   out[t] = sum_{q < nparts} X[t+q] (*) H_MODE(t, q)   for t < nout,
// X rows x0 + r of the planes (xr, xi) (row stride xs), rows r >= nrows
// read as zero; H rows h0 + ... of (hr, hi) (stride hs); out rows o0 + t of
// (outr, outi) (stride os). Planes may be split (re and im apart) or
// interleaved ([re | im] rows: im = re + bins). Each X element is loaded
// once per MAC_TT outputs: the MAC_TT rows of the current q sit in
// registers and slide by one row per q.
template <bool DC, HMode MODE>
__device__ __forceinline__ void mac_rows(int nout, int nrows, int nparts, int k, int t0,
                                         int wp2_0, const float* __restrict__ xr,
                                         const float* __restrict__ xi, size_t xs,
                                         const float* __restrict__ hr,
                                         const float* __restrict__ hi, size_t hs, float b0,
                                         float* __restrict__ outr, float* __restrict__ outi,
                                         size_t os, size_t x0, size_t h0, size_t o0) {
    static_assert(MODE != H_LTI, "the LTI MAC is the tiled one");
    float wr[MAC_TT], wi[MAC_TT], ar[MAC_TT], ai[MAC_TT];
    int m[MAC_TT];   // H_TV: (t0 + j - wp2_0 + q) mod nparts at the current q
    int m0 = MODE == H_TV_PAIR ? pmod(t0 - wp2_0, nparts) : 0;
    // output t0+j at partition q reads X row t0+j+q
#pragma unroll
    for (int j = 0; j < MAC_TT; ++j) {
        const int r = t0 + j;
        wr[j] = r < nrows ? xr[(x0 + r) * xs + k] : 0.f;
        wi[j] = r < nrows ? xi[(x0 + r) * xs + k] : 0.f;
        ar[j] = 0.f;
        ai[j] = 0.f;
        m[j] = MODE == H_TV ? pmod(t0 + j - wp2_0, nparts) : 0;
    }
    for (int q = 0; q < nparts; ++q) {
        float h_r = 0.f, h_i = 0.f, g_r = 0.f, g_i = 0.f;
        int jw = MAC_TT;   // H_TV_PAIR: outputs j >= jw read the second row (g)
        if (MODE == H_TV_PAIR) {
            const size_t ra = h0 + (t0 - m0 + nparts - 1);
            h_r = hr[ra * hs + k];
            h_i = hi[ra * hs + k];
            jw = nparts - m0;
            if (jw < MAC_TT && t0 + jw < nout) {
                g_r = hr[(ra + nparts) * hs + k];
                g_i = hi[(ra + nparts) * hs + k];
            }
            m0 = m0 + 1 == nparts ? 0 : m0 + 1;
        }
#pragma unroll
        for (int j = 0; j < MAC_TT; ++j) {
            float y_r = h_r, y_i = h_i;
            if (MODE == H_TV) {
                const int t = t0 + j;
                const size_t row = h0 + (t - m[j] + nparts - 1);
                y_r = t < nout ? hr[row * hs + k] : 0.f;
                y_i = t < nout ? hi[row * hs + k] : 0.f;
                m[j] = m[j] + 1 == nparts ? 0 : m[j] + 1;
            } else if (MODE == H_TV_PAIR && j >= jw) {
                y_r = g_r;
                y_i = g_i;
            }
            if (DC) {            // packed (DC/2, Nyq/2) bin: componentwise
                ar[j] += wr[j] * y_r;
                ai[j] += wi[j] * y_i;
            } else {
                ar[j] += wr[j] * y_r - wi[j] * y_i;
                ai[j] += wr[j] * y_i + wi[j] * y_r;
            }
        }
#pragma unroll
        for (int j = 0; j < MAC_TT - 1; ++j) {
            wr[j] = wr[j + 1];
            wi[j] = wi[j + 1];
        }
        const int r = t0 + q + MAC_TT;
        wr[MAC_TT - 1] = r < nrows ? xr[(x0 + r) * xs + k] : 0.f;
        wi[MAC_TT - 1] = r < nrows ? xi[(x0 + r) * xs + k] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < MAC_TT; ++j) {
        const int t = t0 + j;
        if (t >= nout) break;
        outr[(o0 + t) * os + k] = DC ? b0 * ar[j] : ar[j];
        outi[(o0 + t) * os + k] = DC ? b0 * ai[j] : ai[j];
    }
}

// mac_rows over the partitions [q0, q1) only, into the caller's
// accumulators (ar, ai) instead of the outputs, for a kernel that splits
// the q range between threads and reduces their sums itself (slidemac.cu),
// in any HMode (H_LTI: H row h0 + q for every output). The MAC_TT window
// is preloaded at X row t0 + q0 and the H rows found from the same
// hrow(t, q) at q = q0. Loads run one partition ahead: the H rows and the
// incoming X row of q + 1 are requested before the products of q, so two
// partitions' loads are in flight at once; the loop runs two partitions a
// trip (faster on the H100 than one or four).
template <bool DC, HMode MODE>
__device__ __forceinline__ void mac_rows_q(int nout, int nrows, int nparts, int k, int t0,
                                           int wp2_0, int q0, int q1,
                                           const float* __restrict__ xr,
                                           const float* __restrict__ xi, size_t xs,
                                           const float* __restrict__ hr,
                                           const float* __restrict__ hi, size_t hs, size_t x0,
                                           size_t h0, float (&ar)[MAC_TT], float (&ai)[MAC_TT]) {
    float wr[MAC_TT], wi[MAC_TT];
    int m[MAC_TT];   // H_TV: (t0 + j - wp2_0 + q) mod nparts at the current q
    int m0 = MODE == H_TV_PAIR ? pmod(t0 - wp2_0 + q0, nparts) : 0;
#pragma unroll
    for (int j = 0; j < MAC_TT; ++j) {
        const int r = t0 + q0 + j;
        wr[j] = r < nrows ? xr[(x0 + r) * xs + k] : 0.f;
        wi[j] = r < nrows ? xi[(x0 + r) * xs + k] : 0.f;
        ar[j] = 0.f;
        ai[j] = 0.f;
        m[j] = MODE == H_TV ? pmod(t0 + j - wp2_0 + q0, nparts) : 0;
    }
    if (q0 >= q1) return;
    // H_TV_PAIR: the two H rows of partition q (h, then g past the wrap at
    // outputs j >= jw), fetched one partition ahead
    auto pair = [&](int mq, float& h_r, float& h_i, float& g_r, float& g_i, int& jw) {
        const size_t ra = h0 + (t0 - mq + nparts - 1);
        h_r = hr[ra * hs + k];
        h_i = hi[ra * hs + k];
        jw = nparts - mq;
        g_r = g_i = 0.f;
        if (jw < MAC_TT && t0 + jw < nout) {
            g_r = hr[(ra + nparts) * hs + k];
            g_i = hi[(ra + nparts) * hs + k];
        }
    };
    float h_r = 0.f, h_i = 0.f, g_r = 0.f, g_i = 0.f;
    int jw = MAC_TT;
    if (MODE == H_TV_PAIR) pair(m0, h_r, h_i, g_r, g_i, jw);
    if (MODE == H_LTI) {
        h_r = hr[(h0 + q0) * hs + k];
        h_i = hi[(h0 + q0) * hs + k];
    }
#pragma unroll 2
    for (int q = q0; q < q1; ++q) {
        // partition q + 1's loads first
        const int r = t0 + q + MAC_TT;
        const float nr = r < nrows ? xr[(x0 + r) * xs + k] : 0.f;
        const float ni = r < nrows ? xi[(x0 + r) * xs + k] : 0.f;
        float h_r1 = 0.f, h_i1 = 0.f, g_r1 = 0.f, g_i1 = 0.f;
        int jw1 = MAC_TT;
        m0 = m0 + 1 == nparts ? 0 : m0 + 1;
        if (MODE == H_TV_PAIR && q + 1 < q1) pair(m0, h_r1, h_i1, g_r1, g_i1, jw1);
        if (MODE == H_LTI && q + 1 < q1) {
            h_r1 = hr[(h0 + q + 1) * hs + k];
            h_i1 = hi[(h0 + q + 1) * hs + k];
        }
#pragma unroll
        for (int j = 0; j < MAC_TT; ++j) {
            float y_r = h_r, y_i = h_i;
            if (MODE == H_TV) {
                const int t = t0 + j;
                const size_t row = h0 + (t - m[j] + nparts - 1);
                y_r = t < nout ? hr[row * hs + k] : 0.f;
                y_i = t < nout ? hi[row * hs + k] : 0.f;
                m[j] = m[j] + 1 == nparts ? 0 : m[j] + 1;
            } else if (j >= jw) {
                y_r = g_r;
                y_i = g_i;
            }
            if (DC) {            // packed (DC/2, Nyq/2) bin: componentwise
                ar[j] += wr[j] * y_r;
                ai[j] += wi[j] * y_i;
            } else {
                ar[j] += wr[j] * y_r - wi[j] * y_i;
                ai[j] += wr[j] * y_i + wi[j] * y_r;
            }
        }
#pragma unroll
        for (int j = 0; j < MAC_TT - 1; ++j) {
            wr[j] = wr[j + 1];
            wi[j] = wi[j + 1];
        }
        wr[MAC_TT - 1] = nr;
        wi[MAC_TT - 1] = ni;
        h_r = h_r1;
        h_i = h_i1;
        g_r = g_r1;
        g_i = g_i1;
        jw = jw1;
    }
}

// Channel c = blockIdx.z of a TV scan below MAC_TT partitions: aext_c[t+1]
// = [acc_re[t] | acc_im[t]] for t < nb, one thread a bin and MAC_TT
// outputs (mac_rows, H_TV); hr is the coefficient timelines.
__global__ void __launch_bounds__(MAC_THREADS)
mac_tv_kernel(Scan s, const int* __restrict__ wp2, int wp2_stride,
              const float* __restrict__ timeline, const float* __restrict__ hr, float b0,
              float* __restrict__ aext) {
    const int k = blockIdx.y * MAC_THREADS + threadIdx.x;
    if (k >= s.bins) return;
    const size_t c = blockIdx.z;
    const int t0 = blockIdx.x * MAC_TT;
    const size_t b2 = s.b2();
    const size_t x0 = c * s.tl_rows() + 1;   // block t's window starts at row t+1
    const size_t ax0 = c * s.ax_rows() + 1;  // aext row t+1 holds acc[t]
    const int nrows = static_cast<int>(s.tl_rows()) - 1;
    const int wp2_0 = wp2[c * wp2_stride];
    const size_t h0 = c * s.ht_rows();
    if (k == 0)
        mac_rows<true, H_TV>(s.nb, nrows, s.nparts, k, t0, wp2_0, timeline, timeline + s.bins,
                             b2, hr, hr + s.bins, b2, b0, aext, aext + s.bins, b2, x0, h0, ax0);
    else
        mac_rows<false, H_TV>(s.nb, nrows, s.nparts, k, t0, wp2_0, timeline, timeline + s.bins,
                              b2, hr, hr + s.bins, b2, b0, aext, aext + s.bins, b2, x0, h0, ax0);
}

constexpr int TILE_BINS = 32;         // bins a CTA of the tiled MAC: a warp's lanes
constexpr int TILE_MAX_GROUPS = 8;    // warps a CTA
constexpr int TILE_TT_MAX = 16;       // outputs a thread: MAC_TT or this

// The tiled MAC's shape (ops/cuda/streamstep.py mac_plan): G = groups
// warps a CTA, each tt (MAC_TT or TILE_TT_MAX) consecutive outputs of the
// CTA's 32 bins (G * tt outputs a CTA); q partitions a stage, a multiple of
// tt; the timeline ring holds `ring` rows, a power of two of at least
// 2q + outs() - 1 (the rows one stage multiplies and the next stage's new
// ones).
struct MacPlan {
    int groups, tt, q, ring;
    __host__ __device__ int outs() const { return groups * tt; }
    __host__ bool ok() const {
        return groups >= 1 && groups <= TILE_MAX_GROUPS && (tt == MAC_TT || tt == TILE_TT_MAX)
            && q >= tt && q % tt == 0 && (ring & (ring - 1)) == 0 && ring >= 2 * q + outs() - 1;
    }
    // h rows a partition of a stage: one (LTI), or the two a TV tile reads
    __host__ __device__ static constexpr int hrows(HMode mode) { return mode == H_LTI ? 1 : 2; }
    // floats of shared memory: the ring, two stages of h rows ((re, im)
    // pairs)
    __host__ __device__ size_t smem_floats(HMode mode) const {
        return 2 * static_cast<size_t>(ring) * TILE_BINS
            + 2 * static_cast<size_t>(hrows(mode)) * q * 2 * TILE_BINS;
    }
};

// One float from global into shared memory by cp.async; zero where !valid
// (no bytes are read then).
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src, bool valid) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where the tiled MAC reads and writes: channel c's planes start at c times
// the channel strides (xcs, hcs, ocs). X: the first row of output 0's
// window, split (xr, xi) at row stride xs, xrows rows (later rows read as
// zero); H: the IR planes (LTI, row q) or the coefficient timeline (TV),
// (hr, hi) at row stride hs; the outputs: row t of (outr, outi) at row
// stride os. The scans pass their [re | im] timelines and aext from row 1
// (scan_io); the sliding MAC its split planes.
struct MacIO {
    const float* xr;
    const float* xi;
    size_t xs, xcs;
    int xrows;
    const float* hr;
    const float* hi;
    size_t hs, hcs;
    float* outr;
    float* outi;
    size_t os, ocs;
};

// The MacIO of a scan's buffers: the timeline from row 1 (block t's window
// starts at row t + 1), h the IR planes (LTI) or the [re | im] coefficient
// timeline (TV), the outputs into aext from row 1.
MacIO scan_io(const Scan& s, bool tv, const float* timeline, const float* hr,
              const float* hi, float* aext) {
    const size_t b2 = s.b2();
    return {timeline + b2, timeline + b2 + s.bins, b2, s.tl(),
            static_cast<int>(s.tl_rows()) - 1,
            hr, tv ? hr + s.bins : hi, tv ? b2 : static_cast<size_t>(s.bins),
            tv ? s.ht() : s.plane(),
            aext + b2, aext + b2 + s.bins, b2, s.ax()};
}

// The CTA's view of its tile: channel c, outputs [t0, t0 + T), bins
// [k0, k0 + 32); x rows relative to output t0's window of channel c (rows
// >= xrows read as zero) at row stride xs; h rows of (hrc, hic) at row
// stride hs; output t0's row of (outr, outi) at row stride os.
struct MacTile {
    int t0, T, k, xrows, wp2_0, rmask;
    bool kin;
    const float* xb;    // output t0's first window row of channel c, re
    const float* xbi;   // and im
    size_t xs;
    const float* hrc;   // channel c's h rows: IR planes (LTI) or HT_c (TV)
    const float* hic;
    size_t hs;
    float* outr;        // channel c's output row t0
    float* outi;
    size_t os;
};

// The real and imaginary part of one element into (re, im) of a float2 in
// shared memory (the FMAs read both with one load).
__device__ __forceinline__ void cp_async_pair(float2* dst, const float* re, const float* im,
                                              bool valid) {
    cp_async_f32(&dst->x, re, valid);
    cp_async_f32(&dst->y, im, valid);
}

// Issue stage ch's copies: timeline rows [lo, q0 + qn + T - 1) into the
// ring (lo = 0 at stage 0, else q0 + T - 1: the rows stage ch - 1 did not
// load) and the h rows of partitions [q0, q0 + qn) into h buffer ch & 1.
// Warp g copies rows g, g + G, ..., lane l element k0 + l of each.
template <HMode MODE>
__device__ __forceinline__ void mac_stage(const Scan& s, const MacPlan& p, const MacTile& m,
                                          int ch, float2* sx, float2* sh) {
    const int q0 = ch * p.q, qn = min(p.q, s.nparts - q0), lane = threadIdx.x;
    const int lo = ch == 0 ? 0 : q0 + m.T - 1, hi = q0 + qn + m.T - 1;
    for (int r = lo + threadIdx.y; r < hi; r += blockDim.y) {
        const bool v = m.kin && r < m.xrows;
        const size_t at = static_cast<size_t>(r) * m.xs + m.k;
        cp_async_pair(sx + (r & m.rmask) * TILE_BINS + lane, v ? m.xb + at : m.xb,
                      v ? m.xbi + at : m.xb, v);
    }
    constexpr int HR = MacPlan::hrows(MODE);
    float2* hb = sh + (ch & 1) * (HR * p.q * TILE_BINS);
    for (int u = threadIdx.y; u < qn; u += blockDim.y) {
        const int q = q0 + u;
        // LTI: IR row q. TV: the row of the latest block s0 <= t0 with
        // s0 = wp2 - q (mod nparts), then s0 + nparts if a CTA output
        // t <= min(t0 + T, nb) - 1 reaches it.
        int row = q;
        bool second = false;
        if (MODE != H_LTI) {
            const int s0 = m.t0 - pmod(m.t0 - m.wp2_0 + q, s.nparts);
            row = s0 + s.nparts - 1;
            second = s0 + s.nparts <= min(m.t0 + m.T, s.nb) - 1;
        }
        for (int w = 0; w < HR; ++w) {
            const bool v = m.kin && (w == 0 || second);
            const size_t at = static_cast<size_t>(row + w * s.nparts) * m.hs + m.k;
            cp_async_pair(hb + (u * HR + w) * TILE_BINS + lane, v ? m.hrc + at : m.hrc,
                          v ? m.hic + at : m.hic, v);
        }
    }
}

// acc[j] += X row (gt + q + j) (*) y for the TT outputs of a thread at
// partition q = q0 + u, u = u0 + uu: the window's slot of output j is
// (uu + j) mod TT, since the chunk's first window sat in slots 0..; outputs
// j >= jw take g for y. Four FMAs a complex product, accumulated in place.
// (DC: the bin-0 lane multiplies componentwise, written with masked
// factors so that the warp does not diverge.)
template <int TT, bool DC_TILE>
__device__ __forceinline__ void mac_fma(bool dc, int uu, int jw, const float2 (&w)[TT],
                                        float2 h, float2 g, float (&ar)[TT], float (&ai)[TT]) {
#pragma unroll
    for (int j = 0; j < TT; ++j) {
        const float2 x = w[(uu + j) % TT];
        const float y_r = j >= jw ? g.x : h.x, y_i = j >= jw ? g.y : h.y;
        const float p2 = DC_TILE && dc ? 0.f : -y_i, p3 = DC_TILE && dc ? 0.f : y_i;
        const float p4 = DC_TILE && dc ? y_i : y_r;
        ar[j] = fmaf(x.x, y_r, ar[j]);
        ar[j] = fmaf(x.y, p2, ar[j]);
        ai[j] = fmaf(x.x, p3, ai[j]);
        ai[j] = fmaf(x.y, p4, ai[j]);
    }
}

// Partitions q0 + u0 .. q0 + u0 + TT - 1 (FULL) or up to q0 + qn - 1 of the
// thread's TT outputs gt.. (relative to t0), from the ring and h buffer hb
// (this lane's column), each partition's ring row and h row found on its
// own. m0: the TV ring phase (t0 - wp2 + q) mod nparts of the CTA's first
// output at the block's first partition, advanced here. A TV output
// t0 + gt + j reads the CTA's second staged row where m0 + gt + j >= nparts
// (its latest block s = wp2 - q (mod nparts) is then s0 + nparts), else the
// first.
template <HMode MODE, int TT, bool DC_TILE, bool FULL>
__device__ __forceinline__ void mac_block(const Scan& s, const MacTile& m, int q0, int u0,
                                          int qn, int gt, bool dc, const float2* sx,
                                          const float2* hb, int& m0, float2 (&w)[TT],
                                          float (&ar)[TT], float (&ai)[TT]) {
    const float2 zero = make_float2(0.f, 0.f);
#pragma unroll
    for (int uu = 0; uu < TT; ++uu) {
        const int u = u0 + uu;
        if (!FULL && u >= qn) break;
        w[(uu + TT - 1) % TT] = sx[((gt + q0 + u + TT - 1) & m.rmask) * TILE_BINS];
        if (MODE == H_LTI) {
            mac_fma<TT, DC_TILE>(dc, uu, TT, w, hb[u * TILE_BINS], zero, ar, ai);
        } else {
            const int jw = s.nparts - m0 - gt;   // outputs j >= jw: the second row
            const float2* h = hb + u * 2 * TILE_BINS;
            mac_fma<TT, DC_TILE>(dc, uu, jw, w, h[0], h[TILE_BINS], ar, ai);
            m0 = m0 + 1 == s.nparts ? 0 : m0 + 1;
        }
    }
}

// A full block whose ring rows do not wrap and, in the TV MAC, whose TT
// partitions all read one of the two staged rows (hb already points at it):
// no index arithmetic a partition. xb: the ring row of the block's first
// incoming row (this lane's column).
template <HMode MODE, int TT, bool DC_TILE>
__device__ __forceinline__ void mac_block_fast(int u0, bool dc, const float2* xb,
                                               const float2* hb, float2 (&w)[TT],
                                               float (&ar)[TT], float (&ai)[TT]) {
    constexpr int HS = MacPlan::hrows(MODE) * TILE_BINS;
    const float2 zero = make_float2(0.f, 0.f);
    hb += u0 * HS;
#pragma unroll
    for (int uu = 0; uu < TT; ++uu) {
        w[(uu + TT - 1) % TT] = xb[uu * TILE_BINS];
        mac_fma<TT, DC_TILE>(dc, uu, TT, w, hb[uu * HS], zero, ar, ai);
    }
}

// Stage ch's partitions [q0, q0 + qn) for the thread's TT outputs gt..,
// in ascending q: blocks of TT partitions, the fast form where it applies,
// the last block ragged where qn is not a multiple of TT.
template <HMode MODE, int TT, bool DC_TILE>
__device__ __forceinline__ void mac_chunk(const Scan& s, const MacPlan& p, const MacTile& m,
                                          int ch, int gt, bool dc, const float2* sx,
                                          const float2* sh, float (&ar)[TT], float (&ai)[TT]) {
    const int q0 = ch * p.q, qn = min(p.q, s.nparts - q0), lane = threadIdx.x;
    const float2* hb = sh + (ch & 1) * (MacPlan::hrows(MODE) * p.q * TILE_BINS) + lane;
    sx += lane;
    float2 w[TT];
#pragma unroll
    for (int j = 0; j < TT - 1; ++j) w[j] = sx[((gt + q0 + j) & m.rmask) * TILE_BINS];
    int m0 = MODE == H_LTI ? 0 : pmod(m.t0 - m.wp2_0 + q0, s.nparts);
    int u0 = 0;
    for (; u0 + TT <= qn; u0 += TT) {
        const int r0 = (gt + q0 + u0 + TT - 1) & m.rmask;   // warp-uniform tests
        bool fast = r0 + TT - 1 <= m.rmask;
        int second = 0;
        if (MODE != H_LTI) {
            // no phase wrap in the block, and every output on one side of
            // nparts at every partition of it
            const bool first = m0 + gt + 2 * TT - 2 < s.nparts;
            second = m0 + gt >= s.nparts;
            fast = fast && m0 + TT - 1 < s.nparts && (first || second);
        }
        if (fast) {
            mac_block_fast<MODE, TT, DC_TILE>(u0, dc, sx + r0 * TILE_BINS,
                                              hb + second * TILE_BINS, w, ar, ai);
            if (MODE != H_LTI) m0 = m0 + TT == s.nparts ? 0 : m0 + TT;
        } else {
            mac_block<MODE, TT, DC_TILE, true>(s, m, q0, u0, qn, gt, dc, sx, hb, m0, w, ar,
                                               ai);
        }
    }
    if (u0 < qn)
        mac_block<MODE, TT, DC_TILE, false>(s, m, q0, u0, qn, gt, dc, sx, hb, m0, w, ar, ai);
}

template <HMode MODE, int TT, bool DC_TILE>
__device__ __forceinline__ void mac_tile(const Scan& s, const MacPlan& p, const MacTile& m,
                                         float b0, float2* smem) {
    float2* sx = smem;
    float2* sh = sx + (m.rmask + 1) * TILE_BINS;
    const int gt = threadIdx.y * TT;
    const bool dc = DC_TILE && m.k == 0;
    float ar[TT], ai[TT];
#pragma unroll
    for (int j = 0; j < TT; ++j) ar[j] = ai[j] = 0.f;
    const int chunks = cdiv(s.nparts, p.q);
    mac_stage<MODE>(s, p, m, 0, sx, sh);
    cp_async_commit();
    for (int ch = 0; ch < chunks; ++ch) {
        if (ch + 1 < chunks) {
            mac_stage<MODE>(s, p, m, ch + 1, sx, sh);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        mac_chunk<MODE, TT, DC_TILE>(s, p, m, ch, gt, dc, sx, sh, ar, ai);
        __syncthreads();   // before stage ch + 2 overwrites what ch read
    }
    if (!m.kin) return;
    const size_t o = static_cast<size_t>(gt) * m.os + m.k;
#pragma unroll
    for (int j = 0; j < TT; ++j) {
        if (m.t0 + gt + j >= s.nb) break;
        m.outr[o + j * m.os] = dc ? b0 * ar[j] : ar[j];
        m.outi[o + j * m.os] = dc ? b0 * ai[j] : ai[j];
    }
}

// The tiled MAC, H_LTI or H_TV_PAIR (p.outs() <= nparts), TT = p.tt: grid
// (cdiv(nb, p.outs()), cdiv(bins, 32), C), block (32, p.groups), dynamic
// shared memory p.smem_floats(MODE) floats; outputs t < s.nb of every
// channel through io. TV: channel c's ring pointer is wp2[c * wp2_stride]
// (LTI: unread).
template <HMode MODE, int TT>
__global__ void __launch_bounds__(TILE_BINS * TILE_MAX_GROUPS)
mac_tile_kernel(Scan s, MacPlan p, MacIO io, const int* __restrict__ wp2, int wp2_stride,
                float b0) {
    extern __shared__ float2 smem2[];
    const size_t c = blockIdx.z;
    MacTile m;
    m.T = p.outs();
    m.t0 = blockIdx.x * m.T;
    m.k = blockIdx.y * TILE_BINS + threadIdx.x;
    m.kin = m.k < s.bins;
    m.xrows = io.xrows - m.t0;
    const size_t xo = c * io.xcs + static_cast<size_t>(m.t0) * io.xs;
    m.xb = io.xr + xo;
    m.xbi = io.xi + xo;
    m.xs = io.xs;
    m.wp2_0 = MODE == H_LTI ? 0 : wp2[c * wp2_stride];
    m.rmask = p.ring - 1;
    m.hrc = io.hr + c * io.hcs;
    m.hic = io.hi + c * io.hcs;
    m.hs = io.hs;
    const size_t oo = c * io.ocs + static_cast<size_t>(m.t0) * io.os;
    m.outr = io.outr + oo;
    m.outi = io.outi + oo;
    m.os = io.os;
    if (blockIdx.y == 0)
        mac_tile<MODE, TT, true>(s, p, m, b0, smem2);
    else
        mac_tile<MODE, TT, false>(s, p, m, b0, smem2);
}

size_t mac_granted[2][2][64];   // [TV][tt == TILE_TT_MAX][device]

template <HMode MODE, int TT>
cudaError_t launch_mac_tile(const Scan& s, const MacPlan& p, const MacIO& io, const int* wp2,
                            int wp2_stride, float b0, int device, cudaStream_t st) {
    const dim3 grid(cdiv(s.nb, p.outs()), cdiv(s.bins, TILE_BINS), s.C);
    const size_t smem = sizeof(float) * p.smem_floats(MODE);
    RETURN_IF_ERROR(allow_smem(mac_tile_kernel<MODE, TT>, device, smem,
                               mac_granted[MODE != H_LTI][TT == TILE_TT_MAX]));
    mac_tile_kernel<MODE, TT><<<grid, dim3(TILE_BINS, p.groups), smem, st>>>(
        s, p, io, wp2, wp2_stride, b0);
    return cudaGetLastError();
}

// The LTI tiled MAC at plan p: outputs t < s.nb of every channel through io.
cudaError_t launch_lti_tile(const Scan& s, const MacPlan& p, const MacIO& io, float b0,
                            int device, cudaStream_t st) {
    if (!p.ok()) return cudaErrorInvalidValue;
    return p.tt == MAC_TT
        ? launch_mac_tile<H_LTI, MAC_TT>(s, p, io, nullptr, 0, b0, device, st)
        : launch_mac_tile<H_LTI, TILE_TT_MAX>(s, p, io, nullptr, 0, b0, device, st);
}

// The scan's MAC into aext: the tiled kernel at plan p, or mac_tv_kernel
// for a TV scan below MAC_TT partitions.
template <bool tv>
cudaError_t launch_mac(const Scan& s, const MacPlan& p, const int* wp2, int wp2_stride,
                       const float* timeline, const float* hr, const float* hi, float b0,
                       float* aext, int device, cudaStream_t st) {
    if (tv && s.nparts < MAC_TT) {
        mac_tv_kernel<<<dim3(cdiv(s.nb, MAC_TT), cdiv(s.bins, MAC_THREADS), s.C), MAC_THREADS,
                        0, st>>>(s, wp2, wp2_stride, timeline, hr, b0, aext);
        return cudaGetLastError();
    }
    const MacIO io = scan_io(s, tv, timeline, hr, hi, aext);
    if (!tv) return launch_lti_tile(s, p, io, b0, device, st);
    if (!p.ok() || p.outs() > s.nparts) return cudaErrorInvalidValue;
    return p.tt == MAC_TT
        ? launch_mac_tile<H_TV_PAIR, MAC_TT>(s, p, io, wp2, wp2_stride, b0, device, st)
        : launch_mac_tile<H_TV_PAIR, TILE_TT_MAX>(s, p, io, wp2, wp2_stride, b0, device, st);
}

// One row of each of two planes, dr[k] = sr[k] and di[k] = si[k] for k <
// bins, by the CTA's threads: four floats a load where every address is
// 16-byte aligned, else one.
__device__ __forceinline__ void copy_pair(const float* __restrict__ sr,
                                          const float* __restrict__ si, float* __restrict__ dr,
                                          float* __restrict__ di, int bins) {
    const size_t any = reinterpret_cast<size_t>(sr) | reinterpret_cast<size_t>(si)
        | reinterpret_cast<size_t>(dr) | reinterpret_cast<size_t>(di);
    if ((any & 15) == 0 && (bins & 3) == 0) {
        for (int k = threadIdx.x; k < bins / 4; k += blockDim.x) {
            reinterpret_cast<float4*>(dr)[k] = reinterpret_cast<const float4*>(sr)[k];
            reinterpret_cast<float4*>(di)[k] = reinterpret_cast<const float4*>(si)[k];
        }
    } else {
        for (int k = threadIdx.x; k < bins; k += blockDim.x) {
            dr[k] = sr[k];
            di[k] = si[k];
        }
    }
}

// The ring gathers: grid (rows, C), one CTA a row of a channel.
//
// window planes (C, nparts, bins) -> rows [0, nparts) of each channel's
// [re | im] timeline; CTA (0, c) also zeroes channel c's aext rows 0, nb+1
__global__ void __launch_bounds__(ROW_THREADS)
window_in_kernel(Scan s, const float* __restrict__ re, const float* __restrict__ im,
                 float* __restrict__ timeline, float* __restrict__ aext) {
    const int j = blockIdx.x, c = blockIdx.y;
    if (j == 0) {
        float* ax = aext + c * s.ax();
        float* last = ax + (s.nb + 1) * s.b2();
        for (int k = threadIdx.x; k < s.bins; k += blockDim.x)
            ax[k] = ax[s.bins + k] = last[k] = last[s.bins + k] = 0.f;
    }
    const size_t src = c * s.plane() + static_cast<size_t>(j) * s.bins;
    float* row = timeline + c * s.tl() + j * s.b2();
    copy_pair(re + src, im + src, row, row + s.bins, s.bins);
}

// final window: timeline rows [nb, nb+nparts) of each channel -> planes
__global__ void __launch_bounds__(ROW_THREADS)
window_out_kernel(Scan s, const float* __restrict__ timeline, float* __restrict__ re,
                  float* __restrict__ im) {
    const int q = blockIdx.x, c = blockIdx.y;
    const float* row = timeline + c * s.tl() + (static_cast<size_t>(s.nb) + q) * s.b2();
    const size_t dst = c * s.plane() + static_cast<size_t>(q) * s.bins;
    copy_pair(row, row + s.bins, re + dst, im + dst, s.bins);
}

// HT_c rows [0, nparts-1): row j holds the initial ring's frame of
// pseudo-time s = j - (nparts-1), ring slot (wp2_c - s) mod nparts.
__global__ void __launch_bounds__(ROW_THREADS)
h_prefix_kernel(Scan s, const int* __restrict__ wp2, int wp2_stride,
                const float* __restrict__ h0r, const float* __restrict__ h0i,
                float* __restrict__ ht) {
    const int j = blockIdx.x, c = blockIdx.y;
    const int slot = pmod(wp2[c * wp2_stride] - (j - (s.nparts - 1)), s.nparts);
    const size_t src = c * s.plane() + static_cast<size_t>(slot) * s.bins;
    float* row = ht + c * s.ht() + j * s.b2();
    copy_pair(h0r + src, h0i + src, row, row + s.bins, s.bins);
}

// final ring slot q of channel c = HT_c row
// (nb-1) - ((nb-1 - wp2_c + q) mod nparts) + nparts-1
__global__ void __launch_bounds__(ROW_THREADS)
h_final_kernel(Scan s, const int* __restrict__ wp2, int wp2_stride,
               const float* __restrict__ ht, float* __restrict__ hfr,
               float* __restrict__ hfi) {
    const int q = blockIdx.x, c = blockIdx.y;
    const int nb = s.nb, nparts = s.nparts;
    const size_t r = nb - 1 - pmod(nb - 1 - wp2[c * wp2_stride] + q, nparts) + nparts - 1;
    const float* row = ht + c * s.ht() + r * s.b2();
    const size_t dst = c * s.plane() + static_cast<size_t>(q) * s.bins;
    copy_pair(row, row + s.bins, hfr + dst, hfi + dst, s.bins);
}

// The steps every scan shares: the x timelines (initial windows, then
// fwd(blocks) -> rows [nparts, nparts+nb)), the MAC (LTI or TV) into aext,
// post(aext) -> outputs with the overlap-add and the final tails, and the
// final windows. Fwd: cudaError_t(const Scan&, const float* blocks,
// float* timeline, size_t channel_stride, int row0, cudaStream_t);
// Post: cudaError_t(const Scan&, const float* aext, const float* tail0,
// float* outs, float* tailf, cudaStream_t).
template <bool TV, class Fwd, class Post>
cudaError_t run_scan(const Scan& s, const float* blocks, const float* w0r, const float* w0i,
                     const float* hr, const float* hi, const int* wp2, int wp2_stride,
                     const Fwd& fwd, const Post& post, const MacPlan& mac,
                     const float* tail0, float* outs, float* wfr, float* wfi, float* tailf,
                     float* timeline, float* aext, float b0_scale, int device,
                     cudaStream_t st) {
    const dim3 rows(s.nparts, s.C);
    window_in_kernel<<<rows, ROW_THREADS, 0, st>>>(s, w0r, w0i, timeline, aext);
    RETURN_IF_ERROR(cudaGetLastError());
    RETURN_IF_ERROR(fwd(s, blocks, timeline, s.tl(), s.nparts, st));
    RETURN_IF_ERROR(launch_mac<TV>(s, mac, wp2, wp2_stride, timeline, hr, hi, b0_scale, aext,
                                   device, st));
    RETURN_IF_ERROR(post(s, aext, tail0, outs, tailf, st));
    window_out_kernel<<<rows, ROW_THREADS, 0, st>>>(s, timeline, wfr, wfi);
    return cudaGetLastError();
}

// The TV scan: the coefficient timelines (h prefix, then fwd(blocks_h) ->
// rows [nparts-1, nparts-1+nb)), run_scan<true>, the final rings.
template <class Fwd, class Post>
cudaError_t run_tv_scan(const Scan& s, const float* blocks_x, const float* blocks_h,
                        const float* w0r, const float* w0i, const float* h0r,
                        const float* h0i, const int* wp2, int wp2_stride, const Fwd& fwd,
                        const Post& post, const MacPlan& mac, const float* tail0, float* outs,
                        float* wfr, float* wfi, float* hfr, float* hfi, float* tailf,
                        float* timeline, float* htimeline, float* aext, float b0_scale,
                        int device, cudaStream_t st) {
    if (s.nparts > 1) {
        h_prefix_kernel<<<dim3(s.nparts - 1, s.C), ROW_THREADS, 0, st>>>(s, wp2, wp2_stride,
                                                                        h0r, h0i, htimeline);
        RETURN_IF_ERROR(cudaGetLastError());
    }
    RETURN_IF_ERROR(fwd(s, blocks_h, htimeline, s.ht(), s.nparts - 1, st));
    RETURN_IF_ERROR(run_scan<true>(s, blocks_x, w0r, w0i, htimeline, nullptr, wp2, wp2_stride,
                                   fwd, post, mac, tail0, outs, wfr, wfi, tailf, timeline, aext,
                                   b0_scale, device, st));
    h_final_kernel<<<dim3(s.nparts, s.C), ROW_THREADS, 0, st>>>(s, wp2, wp2_stride, htimeline,
                                                                 hfr, hfi);
    return cudaGetLastError();
}

}  // namespace
