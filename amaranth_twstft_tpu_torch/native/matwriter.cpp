// Minimal MAT v5 (Level 5) file writer — the GoRanging::save equivalent.
//
// The reference's production processor writes its per-epoch arrays as
// MATLAB files through libmatio (processing/CPP/main.cpp:521-656) so the
// Octave downstream (gofinal_ltfb.m:41-45, go_1s.m) can load them.  This
// is a dependency-free implementation of the same subset: double-class
// column vectors, real or complex, uncompressed.  Format per the public
// MAT-File Format specification (R2006+ Level 5 layout):
//   128-byte header (116 text + 8 subsys + version 0x0100 + "IM"),
//   per variable one miMATRIX element containing
//     [arrayflags miUINT32x2][dims miINT32x2][name miINT8][pr miDOUBLE]
//     [pi miDOUBLE if complex], every sub-element padded to 8 bytes.
//
// Cross-checked against scipy.io.loadmat in tests/test_torch_native.py.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

namespace {

constexpr uint32_t miINT8 = 1;
constexpr uint32_t miINT32 = 5;
constexpr uint32_t miUINT32 = 6;
constexpr uint32_t miDOUBLE = 9;
constexpr uint32_t miMATRIX = 14;
constexpr uint32_t mxDOUBLE_CLASS = 6;
constexpr uint32_t FLAG_COMPLEX = 0x0800;

struct MatFile {
    FILE *f;
};

void write_tag(FILE *f, uint32_t type, uint32_t nbytes) {
    fwrite(&type, 4, 1, f);
    fwrite(&nbytes, 4, 1, f);
}

void pad8(FILE *f, uint32_t nbytes) {
    static const char zeros[8] = {0};
    uint32_t rem = nbytes % 8;
    if (rem)
        fwrite(zeros, 1, 8 - rem, f);
}

int write_var(FILE *f, const char *name, const double *re, const double *im,
              int64_t n) {
    uint32_t name_len = (uint32_t)strlen(name);
    // uint64: a uint32 parameter would truncate (uint64)n*8 BEFORE the
    // 4 GB body guard below, letting oversized vectors wrap the
    // miMATRIX nbytes instead of returning -2
    auto padded = [](uint64_t b) { return (b + 7u) & ~7ull; };
    uint64_t body = 0;
    body += 8 + 8;                      // array flags
    body += 8 + 8;                      // dims (2 x int32, padded)
    body += 8 + padded(name_len);       // name
    body += 8 + padded((uint64_t)n * 8); // pr
    if (im)
        body += 8 + padded((uint64_t)n * 8); // pi
    if (body > 0xFFFFFFFFu)
        return -2;

    write_tag(f, miMATRIX, (uint32_t)body);
    // array flags
    write_tag(f, miUINT32, 8);
    uint32_t flags = mxDOUBLE_CLASS | (im ? FLAG_COMPLEX : 0);
    uint32_t zero = 0;
    fwrite(&flags, 4, 1, f);
    fwrite(&zero, 4, 1, f);
    // dims: n x 1 column vector (the reference's { array_length, 1 },
    // main.cpp:537)
    write_tag(f, miINT32, 8);
    int32_t dims[2] = {(int32_t)n, 1};
    fwrite(dims, 4, 2, f);
    // name
    write_tag(f, miINT8, name_len);
    fwrite(name, 1, name_len, f);
    pad8(f, name_len);
    // real part
    write_tag(f, miDOUBLE, (uint32_t)(n * 8));
    fwrite(re, 8, (size_t)n, f);
    pad8(f, (uint32_t)((n * 8) % 8));
    if (im) {
        write_tag(f, miDOUBLE, (uint32_t)(n * 8));
        fwrite(im, 8, (size_t)n, f);
        pad8(f, (uint32_t)((n * 8) % 8));
    }
    return 0;
}

} // namespace

extern "C" {

void *twstft_mat_open(const char *path) {
    FILE *f = fopen(path, "wb");
    if (!f)
        return nullptr;
    char header[128];
    memset(header, ' ', 116);
    const char *txt = "MATLAB 5.0 MAT-file, created by amaranth_twstft_tpu "
                      "native matwriter";
    memcpy(header, txt, strlen(txt));
    memset(header + 116, 0, 8); // subsystem offset
    header[124] = 0x00;         // version 0x0100, little endian
    header[125] = 0x01;
    header[126] = 'I';
    header[127] = 'M';
    fwrite(header, 1, 128, f);
    auto *h = new MatFile{f};
    return h;
}

int twstft_mat_write_real(void *hv, const char *name, const double *data,
                          int64_t n) {
    auto *h = (MatFile *)hv;
    return write_var(h->f, name, data, nullptr, n);
}

int twstft_mat_write_complex(void *hv, const char *name, const double *re,
                             const double *im, int64_t n) {
    auto *h = (MatFile *)hv;
    return write_var(h->f, name, re, im, n);
}

int twstft_mat_close(void *hv) {
    auto *h = (MatFile *)hv;
    int rc = fclose(h->f);
    delete h;
    return rc;
}

} // extern "C"
