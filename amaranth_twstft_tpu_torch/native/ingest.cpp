// Host-side capture ingest: mmap + threaded deinterleave of sc16 IQ.
//
// The native half of the framework's IO path — the territory the
// reference covers with C++/C: the UHD capture writer
// (acquisition/rx_multi_samples.cpp:186-216, interleaved int16 frames at
// 40 MB/s sustained), the fread+deinterleave epoch loop
// (processing/CPP/main.cpp:465-483), the decimating df pre-pass reader
// (main.cpp:371-395) and the file-timestamp probe (processing/C/stat.c).
//
// Output layout is float32 (re, im) pairs per channel — the real-valued
// (..., 2) boundary layout of amaranth_twstft_tpu_torch/ops/boundary.py,
// so ingest feeds a host-to-device copy with no further host copy.
//
// Build: amaranth_twstft_tpu_torch/native/__init__.py compiles this file,
// matwriter.cpp and mseq.cpp with g++ into libtwstft_native.so in the
// package's git-ignored build/ directory.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Mapped {
    const int16_t *data = nullptr;
    size_t bytes = 0;
    int fd = -1;
};

bool map_file(const char *path, Mapped &m) {
    m.fd = open(path, O_RDONLY);
    if (m.fd < 0)
        return false;
    struct stat st;
    if (fstat(m.fd, &st) != 0) {
        close(m.fd);
        return false;
    }
    m.bytes = (size_t)st.st_size;
    if (m.bytes == 0) {
        m.data = nullptr;
        return true;
    }
    void *p = mmap(nullptr, m.bytes, PROT_READ, MAP_PRIVATE, m.fd, 0);
    if (p == MAP_FAILED) {
        close(m.fd);
        return false;
    }
    madvise(p, m.bytes, MADV_SEQUENTIAL);
    m.data = (const int16_t *)p;
    return true;
}

void unmap_file(Mapped &m) {
    if (m.data)
        munmap((void *)m.data, m.bytes);
    if (m.fd >= 0)
        close(m.fd);
}

// deinterleave frames [I0 Q0 I1 Q1 ...] -> per-channel (re, im) float pairs
void deinterleave_range(const int16_t *in, int64_t f0, int64_t f1, int nch,
                        float **outs) {
    const int stride = 2 * nch;
    for (int64_t f = f0; f < f1; ++f) {
        const int16_t *frame = in + f * stride;
        for (int c = 0; c < nch; ++c) {
            outs[c][2 * f] = (float)frame[2 * c];
            outs[c][2 * f + 1] = (float)frame[2 * c + 1];
        }
    }
}

} // namespace

extern "C" {

// Frames (complex samples per channel) in an sc16 file.
int64_t twstft_file_frames(const char *path, int nch) {
    struct stat st;
    if (stat(path, &st) != 0)
        return -1;
    return (int64_t)st.st_size / (4 * (int64_t)nch);
}

// Capture-end timestamp recovery from the file mtime (stat.c:20-40,
// processing/README.md:9-11: mtime == end of capture).
double twstft_file_mtime(const char *path) {
    struct stat st;
    if (stat(path, &st) != 0)
        return -1.0;
    return (double)st.st_mtime + (double)st.st_mtim.tv_nsec * 1e-9;
}

// In-memory deinterleave (buffer already loaded).  Returns the threads
// it ran on.
int twstft_deinterleave(const int16_t *in, int64_t n_frames, int nch,
                        float **outs, int n_threads) {
    if (n_threads <= 1 || n_frames < (1 << 16)) {
        deinterleave_range(in, 0, n_frames, nch, outs);
        return 1;
    }
    std::vector<std::thread> ts;
    int64_t per = (n_frames + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t f0 = t * per;
        int64_t f1 = f0 + per < n_frames ? f0 + per : n_frames;
        if (f0 >= f1)
            break;
        ts.emplace_back(deinterleave_range, in, f0, f1, nch, outs);
    }
    for (auto &t : ts)
        t.join();
    return (int)ts.size();
}

// mmap + threaded deinterleave of [start_frame, start_frame + n_frames).
// outs[c] must hold 2*n_frames floats.  Returns frames read (may be short
// at EOF, like the reference's fread loops) or -1 on error; *threads_used,
// where given, gets the threads the deinterleave ran on (0: none ran).
int64_t twstft_ingest_file(const char *path, int nch, int64_t start_frame,
                           int64_t n_frames, float **outs, int n_threads,
                           int *threads_used) {
    if (threads_used)
        *threads_used = 0;
    Mapped m;
    if (!map_file(path, m))
        return -1;
    int64_t total = (int64_t)(m.bytes / (4 * (size_t)nch));
    int64_t avail = total - start_frame;
    if (avail < 0)
        avail = 0;
    int64_t n = n_frames < avail ? n_frames : avail;
    if (n > 0) {
        int used = twstft_deinterleave(m.data + start_frame * 2 * nch, n, nch,
                                       outs, n_threads);
        if (threads_used)
            *threads_used = used;
    }
    unmap_file(m);
    return n;
}

// Strided read of every decim-th frame (the df pre-pass,
// main.cpp:371-395), at most max_out of them, so a capped read touches
// only the file's prefix.  outs[c] must hold 2*max_out floats.  Returns
// min(ceil(frames/decim), max_out) or -1.
int64_t twstft_ingest_decimated(const char *path, int nch, int decim,
                                int64_t max_out, float **outs) {
    Mapped m;
    if (!map_file(path, m))
        return -1;
    int64_t total = (int64_t)(m.bytes / (4 * (size_t)nch));
    int64_t out_n = (total + decim - 1) / decim;
    if (out_n > max_out)
        out_n = max_out;
    const int stride = 2 * nch;
    for (int64_t i = 0; i < out_n; ++i) {
        const int16_t *frame = m.data + (i * (int64_t)decim) * stride;
        for (int c = 0; c < nch; ++c) {
            outs[c][2 * i] = (float)frame[2 * c];
            outs[c][2 * i + 1] = (float)frame[2 * c + 1];
        }
    }
    unmap_file(m);
    return out_n;
}

// int8 quantization of an sc16 frame range — the host-side convert of
// the accelerated transfer path (the reference's host convert is C++
// too: processing/CPP/main.cpp:475-483).  Two threaded passes over the
// mmap: (1) min/max -> scale, (2) quantize.  Bit-for-bit identical to
// the plain quantizer of utils/io.read_sc16_epochs_q8
// (tests/test_torch_native.py):
//   exact mode: scale = max|x|/127 (double), q = rint(x * float(1/scale))
//               clamped to [-127, 127] (round-to-nearest-even),
//   pow2 mode:  sh = smallest s >= 0 with 127<<s >= max|x|,
//               q = clamp((int32(x) + half) >> sh), half = 1<<(sh-1).
// select: -1 = all channels' columns (width 2*nch), else one channel's
// I/Q columns (width 2).  decim > 0 additionally emits every decim-th
// SELECTED frame (relative to start_frame) as float32 into dec_out —
// the df pre-pass ingest fused into the same pass, so the capture is
// read ONCE (the separate strided pre-pass read pages in the whole
// file again, processing/CPP/main.cpp:371-395 territory).
// Returns frames quantized (short at EOF) or -1; *scale_out set;
// *dec_n_out = decimated frames emitted.

} // extern "C" — helper namespace needs C++ linkage (templates)

namespace {

struct QuantSpan {
    const int16_t *base;   // first selected column of frame 0
    int stride;            // int16s per frame
    int width;             // selected int16s per frame (2 or 2*nch)
    int64_t n;             // frames
};

void minmax_range(const QuantSpan *sp, int64_t f0, int64_t f1, int *mn_out,
                  int *mx_out) {
    int mn = 0, mx = 0;
    for (int64_t f = f0; f < f1; ++f) {
        const int16_t *p = sp->base + f * sp->stride;
        for (int k = 0; k < sp->width; ++k) {
            int v = p[k];
            if (v < mn) mn = v;
            if (v > mx) mx = v;
        }
    }
    *mn_out = mn;
    *mx_out = mx;
}

void quant_exact_range(const QuantSpan *sp, int64_t f0, int64_t f1, float inv,
                       int8_t *out) {
    for (int64_t f = f0; f < f1; ++f) {
        const int16_t *p = sp->base + f * sp->stride;
        int8_t *o = out + f * sp->width;
        for (int k = 0; k < sp->width; ++k) {
            float v = (float)p[k] * inv;
            int q = (int)lrintf(v);  // round-to-nearest-even, like rint
            if (q > 127) q = 127;
            if (q < -127) q = -127;
            o[k] = (int8_t)q;
        }
    }
}

void quant_pow2_range(const QuantSpan *sp, int64_t f0, int64_t f1, int sh,
                      int32_t half, int8_t *out) {
    for (int64_t f = f0; f < f1; ++f) {
        const int16_t *p = sp->base + f * sp->stride;
        int8_t *o = out + f * sp->width;
        for (int k = 0; k < sp->width; ++k) {
            int32_t q = ((int32_t)p[k] + half) >> sh;
            if (q > 127) q = 127;
            if (q < -127) q = -127;
            o[k] = (int8_t)q;
        }
    }
}

template <typename Fn>
void run_threaded(int64_t n, int n_threads, Fn fn) {
    if (n_threads <= 1 || n < (1 << 16)) {
        fn(0, (int64_t)0, n);
        return;
    }
    std::vector<std::thread> ts;
    int64_t per = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t f0 = t * per;
        int64_t f1 = f0 + per < n ? f0 + per : n;
        if (f0 >= f1) break;
        ts.emplace_back([=] { fn(t, f0, f1); });
    }
    for (auto &t : ts) t.join();
}

} // namespace

extern "C" {

int64_t twstft_quantize_q8(const char *path, int nch, int64_t start_frame,
                           int64_t n_frames, int select, int pow2,
                           int8_t *out, double *scale_out, int n_threads,
                           int decim, float *dec_out, int64_t *dec_n_out) {
    Mapped m;
    if (!map_file(path, m))
        return -1;
    int64_t total = (int64_t)(m.bytes / (4 * (size_t)nch));
    int64_t avail = total - start_frame;
    if (avail < 0) avail = 0;
    int64_t n = n_frames < avail ? n_frames : avail;
    QuantSpan sp;
    sp.stride = 2 * nch;
    sp.width = select >= 0 ? 2 : 2 * nch;
    sp.base = m.data + start_frame * sp.stride +
              (select >= 0 ? 2 * select : 0);
    sp.n = n;
    if (n == 0) {
        unmap_file(m);
        if (scale_out) *scale_out = 1.0;
        if (dec_n_out) *dec_n_out = 0;
        return 0;
    }
    // pass 1: max|x| via min/max (abs of -32768 would wrap)
    if (n_threads > 8) n_threads = 8;
    std::vector<int> mns(n_threads > 0 ? n_threads : 1, 0),
        mxs(n_threads > 0 ? n_threads : 1, 0);
    run_threaded(n, n_threads, [&](int t, int64_t f0, int64_t f1) {
        minmax_range(&sp, f0, f1, &mns[t], &mxs[t]);
    });
    int mn = 0, mx = 0;
    for (size_t i = 0; i < mns.size(); ++i) {
        if (mns[i] < mn) mn = mns[i];
        if (mxs[i] > mx) mx = mxs[i];
    }
    int64_t smax = mx > -(int64_t)mn ? mx : -(int64_t)mn;
    // pass 2: quantize (+ fused decimated float32 emit)
    double scale;
    if (pow2) {
        int sh = 0;
        while (((int64_t)127 << sh) < smax) ++sh;
        scale = (double)((int64_t)1 << sh);
        int32_t half = sh > 0 ? (1 << (sh - 1)) : 0;
        run_threaded(n, n_threads, [&](int, int64_t f0, int64_t f1) {
            quant_pow2_range(&sp, f0, f1, sh, half, out);
        });
    } else {
        scale = (smax > 1 ? (double)smax : 1.0) / 127.0;
        float inv = (float)(1.0 / scale);
        run_threaded(n, n_threads, [&](int, int64_t f0, int64_t f1) {
            quant_exact_range(&sp, f0, f1, inv, out);
        });
    }
    int64_t dn = 0;
    if (decim > 0 && dec_out) {
        for (int64_t f = 0; f < n; f += decim, ++dn) {
            const int16_t *p = sp.base + f * sp.stride;
            float *o = dec_out + dn * sp.width;
            for (int k = 0; k < sp.width; ++k)
                o[k] = (float)p[k];
        }
    }
    if (dec_n_out) *dec_n_out = dn;
    if (scale_out) *scale_out = scale;
    unmap_file(m);
    return n;
}

// Raw int16 copy of an sc16 frame range (the "ship the wire format"
// ingest: zero host convert, the device casts int16 -> f32 exactly —
// bit-identical to float32 ingest at HALF the bytes).  select as above.
// Returns frames copied or -1.
int64_t twstft_read_raw16(const char *path, int nch, int64_t start_frame,
                          int64_t n_frames, int select, int16_t *out,
                          int n_threads) {
    Mapped m;
    if (!map_file(path, m))
        return -1;
    int64_t total = (int64_t)(m.bytes / (4 * (size_t)nch));
    int64_t avail = total - start_frame;
    if (avail < 0) avail = 0;
    int64_t n = n_frames < avail ? n_frames : avail;
    const int stride = 2 * nch;
    const int width = select >= 0 ? 2 : stride;
    const int16_t *base =
        m.data + start_frame * stride + (select >= 0 ? 2 * select : 0);
    if (n > 0) {
        if (width == stride) {
            run_threaded(n, n_threads, [&](int, int64_t f0, int64_t f1) {
                memcpy(out + f0 * stride, base + f0 * stride,
                       (size_t)(f1 - f0) * stride * sizeof(int16_t));
            });
        } else {
            run_threaded(n, n_threads, [&](int, int64_t f0, int64_t f1) {
                for (int64_t f = f0; f < f1; ++f) {
                    out[2 * f] = base[f * stride];
                    out[2 * f + 1] = base[f * stride + 1];
                }
            });
        }
    }
    unmap_file(m);
    return n;
}

// Interleave float (re, im) channel pairs back into an sc16 file with
// int16 saturation (the SDR writer's wire format,
// rx_multi_samples.cpp:155).  Returns frames written or -1.
int64_t twstft_write_sc16(const char *path, int nch, const float **ins,
                          int64_t n_frames) {
    FILE *f = fopen(path, "wb");
    if (!f)
        return -1;
    std::vector<int16_t> buf(4096 * 2 * nch);
    int64_t written = 0;
    while (written < n_frames) {
        int64_t chunk = n_frames - written;
        if (chunk > 4096)
            chunk = 4096;
        for (int64_t i = 0; i < chunk; ++i) {
            for (int c = 0; c < nch; ++c) {
                for (int k = 0; k < 2; ++k) {
                    float v = ins[c][2 * (written + i) + k];
                    if (v > 32767.f)
                        v = 32767.f;
                    if (v < -32768.f)
                        v = -32768.f;
                    buf[(i * nch + c) * 2 + k] = (int16_t)lrintf(v);
                }
            }
        }
        size_t nw = fwrite(buf.data(), 4 * nch, (size_t)chunk, f);
        written += (int64_t)nw;
        if ((int64_t)nw != chunk)
            break;
    }
    fclose(f);
    return written;
}

} // extern "C"
