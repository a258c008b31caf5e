// The parts of the whole-scan partitioned convolution that the dense-table
// scans (streamstep.cu: TPU kernels stream_steps_fused{,_tv,_batched,
// _batched_tv}) and the split scans (splitstep.cu:
// stream_steps_fused_split{,_tv}) share, and the timeline MAC that the TV
// sliding MAC (slidemac.cu: macflow_tv{,_batched}) runs too. The two scan
// families differ only in how a block becomes its frame spectra and how an
// accumulator becomes its output block: each source passes those two steps
// to run_scan / run_tv_scan as functors.
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

#pragma once

#include "sgemm_tile.cuh"

namespace {

using sgemm::cdiv;

constexpr int MAC_TT = 8;          // output rows per MAC thread
constexpr int MAC_THREADS = 128;   // bins per MAC block
constexpr int ROW_THREADS = 128;   // bins per block of the ring gathers

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
// partition q. H_LTI: the IR ring, row q for every output. H_TV: the
// coefficient timeline, row t - ((t - wp2_0 + q) mod nparts) + nparts - 1
// for output t, any nparts. H_TV_PAIR (nparts >= MAC_TT): with
// m0 = (t0 - wp2_0 + q) mod nparts, outputs t0+j with m0 + j < nparts read
// row ra = t0 - m0 + nparts - 1 and the others (past the one wrap) row
// ra + nparts, so two row loads per q serve all MAC_TT outputs.
enum HMode { H_LTI, H_TV, H_TV_PAIR };

// One channel's MAC_TT outputs t0.. of bin k:
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
        if (MODE == H_LTI) {
            h_r = hr[(h0 + q) * hs + k];
            h_i = hi[(h0 + q) * hs + k];
        } else if (MODE == H_TV_PAIR) {
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
// the q range between threads and reduces their sums itself (slidemac.cu).
// The MAC_TT window is preloaded at X row t0 + q0 and the H rows found from
// the same hrow(t, q) at q = q0. Loads run one partition ahead: the H rows
// and the incoming X row of q + 1 are requested before the products of q,
// so two partitions' loads are in flight at once; the loop runs two
// partitions a trip (faster on the H100 than one or four).
template <bool DC, HMode MODE>
__device__ __forceinline__ void mac_rows_q(int nout, int nrows, int nparts, int k, int t0,
                                           int wp2_0, int q0, int q1,
                                           const float* __restrict__ xr,
                                           const float* __restrict__ xi, size_t xs,
                                           const float* __restrict__ hr,
                                           const float* __restrict__ hi, size_t hs, size_t x0,
                                           size_t h0, float (&ar)[MAC_TT], float (&ai)[MAC_TT]) {
    static_assert(MODE != H_LTI, "the q-range MAC is the TV sliding MAC's");
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

// Channel c = blockIdx.z of a scan: aext_c[t+1] = [acc_re[t] | acc_im[t]]
// for t < nb. LTI: (hr, hi) are the IR planes (C, nparts, bins); TV: hr is
// the coefficient timelines and hi is unused; channel c's ring pointer is
// wp2[c * wp2_stride]. Every channel is indexed from the kernel-argument
// base pointers (per-channel base pointers measured slower).
template <HMode MODE>
__global__ void __launch_bounds__(MAC_THREADS)
mac_kernel(Scan s, const int* __restrict__ wp2, int wp2_stride,
           const float* __restrict__ timeline, const float* __restrict__ hr,
           const float* __restrict__ hi, float b0, float* __restrict__ aext) {
    const int k = blockIdx.y * MAC_THREADS + threadIdx.x;
    if (k >= s.bins) return;
    const size_t c = blockIdx.z;
    const int t0 = blockIdx.x * MAC_TT;
    const size_t b2 = s.b2();
    const size_t x0 = c * s.tl_rows() + 1;   // block t's window starts at row t+1
    const size_t ax0 = c * s.ax_rows() + 1;  // aext row t+1 holds acc[t]
    const int nrows = static_cast<int>(s.tl_rows()) - 1;
    const int wp2_0 = MODE == H_LTI ? 0 : wp2[c * wp2_stride];
    const float* h_i = MODE == H_LTI ? hi : hr + s.bins;
    const size_t hs = MODE == H_LTI ? s.bins : b2;
    const size_t h0 = c * (MODE == H_LTI ? s.nparts : s.ht_rows());
    if (k == 0)
        mac_rows<true, MODE>(s.nb, nrows, s.nparts, k, t0, wp2_0, timeline, timeline + s.bins,
                             b2, hr, h_i, hs, b0, aext, aext + s.bins, b2, x0, h0, ax0);
    else
        mac_rows<false, MODE>(s.nb, nrows, s.nparts, k, t0, wp2_0, timeline,
                              timeline + s.bins, b2, hr, h_i, hs, b0, aext, aext + s.bins, b2,
                              x0, h0, ax0);
}

// window planes (C, nparts, bins) -> rows [0, nparts) of each channel's
// [re | im] timeline
__global__ void __launch_bounds__(ROW_THREADS)
window_in_kernel(Scan s, const float* __restrict__ re, const float* __restrict__ im,
                 float* __restrict__ timeline, float* __restrict__ aext) {
    const int j = blockIdx.x, c = blockIdx.z;
    const int k = blockIdx.y * ROW_THREADS + threadIdx.x;
    if (k >= s.bins) return;
    if (j == 0) {             // the zero rows 0 and nb+1 of the channel's aext
        float* ax = aext + c * s.ax();
        float* last = ax + (s.nb + 1) * s.b2();
        ax[k] = ax[s.bins + k] = last[k] = last[s.bins + k] = 0.f;
    }
    const size_t src = c * s.plane() + static_cast<size_t>(j) * s.bins + k;
    float* row = timeline + c * s.tl() + j * s.b2();
    row[k] = re[src];
    row[s.bins + k] = im[src];
}

// final window: timeline rows [nb, nb+nparts) of each channel -> planes
__global__ void __launch_bounds__(ROW_THREADS)
window_out_kernel(Scan s, const float* __restrict__ timeline, float* __restrict__ re,
                  float* __restrict__ im) {
    const int q = blockIdx.x, c = blockIdx.z;
    const int k = blockIdx.y * ROW_THREADS + threadIdx.x;
    if (k >= s.bins) return;
    const float* row = timeline + c * s.tl() + (static_cast<size_t>(s.nb) + q) * s.b2();
    const size_t dst = c * s.plane() + static_cast<size_t>(q) * s.bins + k;
    re[dst] = row[k];
    im[dst] = row[s.bins + k];
}

// HT_c rows [0, nparts-1): row j holds the initial ring's frame of
// pseudo-time s = j - (nparts-1), ring slot (wp2_c - s) mod nparts.
__global__ void __launch_bounds__(ROW_THREADS)
h_prefix_kernel(Scan s, const int* __restrict__ wp2, int wp2_stride,
                const float* __restrict__ h0r, const float* __restrict__ h0i,
                float* __restrict__ ht) {
    const int j = blockIdx.x, c = blockIdx.z;
    const int k = blockIdx.y * ROW_THREADS + threadIdx.x;
    if (k >= s.bins) return;
    const int slot = pmod(wp2[c * wp2_stride] - (j - (s.nparts - 1)), s.nparts);
    const size_t src = c * s.plane() + static_cast<size_t>(slot) * s.bins + k;
    float* row = ht + c * s.ht() + j * s.b2();
    row[k] = h0r[src];
    row[s.bins + k] = h0i[src];
}

// final ring slot q of channel c = HT_c row
// (nb-1) - ((nb-1 - wp2_c + q) mod nparts) + nparts-1
__global__ void __launch_bounds__(ROW_THREADS)
h_final_kernel(Scan s, const int* __restrict__ wp2, int wp2_stride,
               const float* __restrict__ ht, float* __restrict__ hfr,
               float* __restrict__ hfi) {
    const int q = blockIdx.x, c = blockIdx.z;
    const int k = blockIdx.y * ROW_THREADS + threadIdx.x;
    if (k >= s.bins) return;
    const int nb = s.nb, nparts = s.nparts;
    const size_t r = nb - 1 - pmod(nb - 1 - wp2[c * wp2_stride] + q, nparts) + nparts - 1;
    const float* row = ht + c * s.ht() + r * s.b2();
    const size_t dst = c * s.plane() + static_cast<size_t>(q) * s.bins + k;
    hfr[dst] = row[k];
    hfi[dst] = row[s.bins + k];
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
                     const Fwd& fwd, const Post& post, const float* tail0, float* outs,
                     float* wfr, float* wfi, float* tailf, float* timeline, float* aext,
                     float b0_scale, cudaStream_t st) {
    const dim3 rows(s.nparts, cdiv(s.bins, ROW_THREADS), s.C);
    window_in_kernel<<<rows, ROW_THREADS, 0, st>>>(s, w0r, w0i, timeline, aext);
    SGEMM_RETURN_IF_ERROR(cudaGetLastError());
    SGEMM_RETURN_IF_ERROR(fwd(s, blocks, timeline, s.tl(), s.nparts, st));
    const dim3 mac(cdiv(s.nb, MAC_TT), cdiv(s.bins, MAC_THREADS), s.C);
    if (!TV)
        mac_kernel<H_LTI><<<mac, MAC_THREADS, 0, st>>>(s, wp2, wp2_stride, timeline, hr, hi,
                                                        b0_scale, aext);
    else if (s.nparts >= MAC_TT)
        mac_kernel<H_TV_PAIR><<<mac, MAC_THREADS, 0, st>>>(s, wp2, wp2_stride, timeline, hr,
                                                            hi, b0_scale, aext);
    else
        mac_kernel<H_TV><<<mac, MAC_THREADS, 0, st>>>(s, wp2, wp2_stride, timeline, hr, hi,
                                                       b0_scale, aext);
    SGEMM_RETURN_IF_ERROR(cudaGetLastError());
    SGEMM_RETURN_IF_ERROR(post(s, aext, tail0, outs, tailf, st));
    window_out_kernel<<<rows, ROW_THREADS, 0, st>>>(s, timeline, wfr, wfi);
    return cudaGetLastError();
}

// The TV scan: the coefficient timelines (h prefix, then fwd(blocks_h) ->
// rows [nparts-1, nparts-1+nb)), run_scan<true>, the final rings.
template <class Fwd, class Post>
cudaError_t run_tv_scan(const Scan& s, const float* blocks_x, const float* blocks_h,
                        const float* w0r, const float* w0i, const float* h0r,
                        const float* h0i, const int* wp2, int wp2_stride, const Fwd& fwd,
                        const Post& post, const float* tail0, float* outs, float* wfr,
                        float* wfi, float* hfr, float* hfi, float* tailf, float* timeline,
                        float* htimeline, float* aext, float b0_scale, cudaStream_t st) {
    if (s.nparts > 1) {
        h_prefix_kernel<<<dim3(s.nparts - 1, cdiv(s.bins, ROW_THREADS), s.C), ROW_THREADS, 0,
                          st>>>(s, wp2, wp2_stride, h0r, h0i, htimeline);
        SGEMM_RETURN_IF_ERROR(cudaGetLastError());
    }
    SGEMM_RETURN_IF_ERROR(fwd(s, blocks_h, htimeline, s.ht(), s.nparts - 1, st));
    SGEMM_RETURN_IF_ERROR(run_scan<true>(s, blocks_x, w0r, w0i, htimeline, nullptr, wp2,
                                         wp2_stride, fwd, post, tail0, outs, wfr, wfi, tailf,
                                         timeline, aext, b0_scale, st));
    h_final_kernel<<<dim3(s.nparts, cdiv(s.bins, ROW_THREADS), s.C), ROW_THREADS, 0, st>>>(
        s, wp2, wp2_stride, htimeline, hfr, hfi);
    return cudaGetLastError();
}

}  // namespace
