// Native host-side JPEG decode + Pillow-exact resample + crop: a copy of
// the JAX package's native/decoder.cpp (host-only code, no accelerator).
//
// Purpose: the host image pipeline (decode -> shorter-side bilinear resize ->
// center crop, the deterministic prefix of the reference's canonical
// transform, train_best_RESNET50_Truncate.py:126-132) feeds every training
// step and every served request. Pillow holds the GIL for most of JPEG
// decode, so the threaded HostLoader collapses to ~1 core. This module is
// called through ctypes (which releases the GIL), giving genuinely parallel
// decode across loader threads.
//
// Parity contract: output is BIT-IDENTICAL to the PIL path in
// data/loader.py::decode_image_staged_bytes. JPEG decode uses libjpeg's
// default ISLOW integer IDCT + fancy upsampling (the same settings Pillow
// uses), and the resample reimplements Pillow's Resample.c BILINEAR path
// exactly: antialiased triangle filter, double-precision coefficient
// precomputation, 22-bit fixed-point separable passes (horizontal then
// vertical) with Pillow's rounding and clip8. Verified in
// tests/test_torch_native_decoder.py.
//
// Thread-safety: no global state; every call owns its libjpeg instance and
// scratch buffers.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <jerror.h>

#include <csetjmp>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <cstdint>

namespace {

constexpr int PRECISION_BITS = 32 - 8 - 2;  // Pillow Resample.c

inline uint8_t clip8(int in) {
    if (in >= (1 << PRECISION_BITS << 8)) return 255;
    if (in <= 0) return 0;
    return (uint8_t)(in >> PRECISION_BITS);
}

inline double bilinear_filter(double x) {
    if (x < 0.0) x = -x;
    if (x < 1.0) return 1.0 - x;
    return 0.0;
}

// Pillow's precompute_coeffs for the full-extent box [0, inSize).
// Returns ksize; fills *boundsp (outSize*2: xmin, count) and *kkp
// (outSize*ksize doubles). Caller frees both.
int precompute_coeffs(int inSize, int outSize, int **boundsp, double **kkp) {
    double scale = (double)inSize / outSize;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    double support = 1.0 * filterscale;  // BILINEAR support = 1.0
    int ksize = (int)ceil(support) * 2 + 1;

    double *kk = (double *)malloc((size_t)outSize * ksize * sizeof(double));
    int *bounds = (int *)malloc((size_t)outSize * 2 * sizeof(int));
    if (!kk || !bounds) {
        free(kk);
        free(bounds);
        return 0;
    }
    for (int xx = 0; xx < outSize; xx++) {
        double center = (xx + 0.5) * scale;
        double ww = 0.0;
        double ss = 1.0 / filterscale;
        int xmin = (int)(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = (int)(center + support + 0.5);
        if (xmax > inSize) xmax = inSize;
        xmax -= xmin;
        double *k = &kk[(size_t)xx * ksize];
        int x = 0;
        for (; x < xmax; x++) {
            double w = bilinear_filter((x + xmin - center + 0.5) * ss);
            k[x] = w;
            ww += w;
        }
        for (x = 0; x < xmax; x++) {
            if (ww != 0.0) k[x] /= ww;
        }
        for (; x < ksize; x++) k[x] = 0.0;
        bounds[xx * 2 + 0] = xmin;
        bounds[xx * 2 + 1] = xmax;
    }
    *boundsp = bounds;
    *kkp = kk;
    return ksize;
}

// Pillow's normalize_coeffs_8bpc rounding.
int *normalize_coeffs(int outSize, int ksize, const double *prekk) {
    int *kk = (int *)malloc((size_t)outSize * ksize * sizeof(int));
    if (!kk) return nullptr;
    for (long x = 0; x < (long)outSize * ksize; x++) {
        if (prekk[x] < 0) {
            kk[x] = (int)(-0.5 + prekk[x] * (1 << PRECISION_BITS));
        } else {
            kk[x] = (int)(0.5 + prekk[x] * (1 << PRECISION_BITS));
        }
    }
    return kk;
}

// Horizontal resample, RGB interleaved: (in_h, in_w, 3) -> (in_h, out_w, 3).
void resample_horizontal(const uint8_t *in, int in_w, int in_h, uint8_t *out,
                         int out_w, const int *bounds, const int *kk,
                         int ksize) {
    for (int yy = 0; yy < in_h; yy++) {
        const uint8_t *row = in + (size_t)yy * in_w * 3;
        uint8_t *orow = out + (size_t)yy * out_w * 3;
        for (int xx = 0; xx < out_w; xx++) {
            int xmin = bounds[xx * 2 + 0];
            int xmax = bounds[xx * 2 + 1];
            const int *k = &kk[(size_t)xx * ksize];
            int s0 = 1 << (PRECISION_BITS - 1);
            int s1 = s0, s2 = s0;
            const uint8_t *p = row + (size_t)xmin * 3;
            for (int x = 0; x < xmax; x++) {
                s0 += p[0] * k[x];
                s1 += p[1] * k[x];
                s2 += p[2] * k[x];
                p += 3;
            }
            orow[xx * 3 + 0] = clip8(s0);
            orow[xx * 3 + 1] = clip8(s1);
            orow[xx * 3 + 2] = clip8(s2);
        }
    }
}

// Vertical resample: (in_h, w, 3) -> (out_h, w, 3).
void resample_vertical(const uint8_t *in, int w, uint8_t *out, int out_h,
                       const int *bounds, const int *kk, int ksize) {
    int row_elems = w * 3;
    for (int yy = 0; yy < out_h; yy++) {
        int ymin = bounds[yy * 2 + 0];
        int ymax = bounds[yy * 2 + 1];
        const int *k = &kk[(size_t)yy * ksize];
        uint8_t *orow = out + (size_t)yy * row_elems;
        for (int xx = 0; xx < row_elems; xx++) {
            int ss = 1 << (PRECISION_BITS - 1);
            const uint8_t *p = in + (size_t)ymin * row_elems + xx;
            for (int y = 0; y < ymax; y++) {
                ss += *p * k[y];
                p += row_elems;
            }
            orow[xx] = clip8(ss);
        }
    }
}

// Resample (in_h, in_w, 3) -> (th, tw, 3), Pillow pass order (horizontal
// first), skipping identity passes exactly as ImagingResample does.
// Returns 0 on success (result in *outp, caller frees), 1 on alloc failure.
int resample(const uint8_t *in, int in_w, int in_h, int tw, int th,
             uint8_t **outp) {
    const uint8_t *cur = in;
    uint8_t *tmp = nullptr;
    int cur_w = in_w, cur_h = in_h;

    if (tw != in_w) {
        int *bounds;
        double *prekk;
        int ksize = precompute_coeffs(in_w, tw, &bounds, &prekk);
        if (!ksize) return 1;
        int *kk = normalize_coeffs(tw, ksize, prekk);
        free(prekk);
        if (!kk) {
            free(bounds);
            return 1;
        }
        tmp = (uint8_t *)malloc((size_t)in_h * tw * 3);
        if (!tmp) {
            free(bounds);
            free(kk);
            return 1;
        }
        resample_horizontal(cur, in_w, in_h, tmp, tw, bounds, kk, ksize);
        free(bounds);
        free(kk);
        cur = tmp;
        cur_w = tw;
    }
    if (th != in_h) {
        int *bounds;
        double *prekk;
        int ksize = precompute_coeffs(in_h, th, &bounds, &prekk);
        if (!ksize) {
            free(tmp);
            return 1;
        }
        int *kk = normalize_coeffs(th, ksize, prekk);
        free(prekk);
        if (!kk) {
            free(bounds);
            free(tmp);
            return 1;
        }
        uint8_t *vout = (uint8_t *)malloc((size_t)th * cur_w * 3);
        if (!vout) {
            free(bounds);
            free(kk);
            free(tmp);
            return 1;
        }
        resample_vertical(cur, cur_w, vout, th, bounds, kk, ksize);
        free(bounds);
        free(kk);
        free(tmp);
        *outp = vout;
        return 0;
    }
    if (cur == in) {  // both passes skipped: copy
        tmp = (uint8_t *)malloc((size_t)cur_h * cur_w * 3);
        if (!tmp) return 1;
        memcpy(tmp, in, (size_t)cur_h * cur_w * 3);
    }
    *outp = tmp;
    return 0;
}

// ---- libjpeg plumbing -------------------------------------------------

struct ErrorMgr {
    jpeg_error_mgr pub;
    jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
    ErrorMgr *err = (ErrorMgr *)cinfo->err;
    longjmp(err->setjmp_buffer, 1);
}

// Silence console output but still COUNT corruption warnings (msg_level -1,
// e.g. JWRN_JPEG_EOF on truncated files) — decode_rgb fails on any warning
// so damaged files fall back to PIL, which surfaces them like the old path.
void emit_message(j_common_ptr cinfo, int msg_level) {
    if (msg_level < 0) cinfo->err->num_warnings++;
}

// Memory source manager (portable: jpeg_mem_src is not in every 62 ABI).
struct MemSource {
    jpeg_source_mgr pub;
    const uint8_t *data;
    unsigned long size;
};

void init_source(j_decompress_ptr) {}

boolean fill_input_buffer(j_decompress_ptr cinfo) {
    // Input exhausted: feed a fake EOI so libjpeg errors out cleanly.
    static const JOCTET eoi[2] = {0xFF, JPEG_EOI};
    cinfo->src->next_input_byte = eoi;
    cinfo->src->bytes_in_buffer = 2;
    return TRUE;
}

void skip_input_data(j_decompress_ptr cinfo, long num_bytes) {
    jpeg_source_mgr *src = cinfo->src;
    if (num_bytes <= 0) return;
    if ((unsigned long)num_bytes > src->bytes_in_buffer) {
        src->next_input_byte += src->bytes_in_buffer;
        src->bytes_in_buffer = 0;
        fill_input_buffer(cinfo);
    } else {
        src->next_input_byte += num_bytes;
        src->bytes_in_buffer -= num_bytes;
    }
}

void term_source(j_decompress_ptr) {}

void set_mem_source(j_decompress_ptr cinfo, MemSource *src,
                    const uint8_t *data, unsigned long size) {
    src->pub.init_source = init_source;
    src->pub.fill_input_buffer = fill_input_buffer;
    src->pub.skip_input_data = skip_input_data;
    src->pub.resync_to_restart = jpeg_resync_to_restart;
    src->pub.term_source = term_source;
    src->pub.next_input_byte = data;
    src->pub.bytes_in_buffer = size;
    src->data = data;
    src->size = size;
    cinfo->src = &src->pub;
}

// Decode to interleaved RGB. Returns 0 on success; fills (*outp, *wp, *hp)
// with the (possibly DCT-scaled) output dims. scale_denom in {1,2,4,8}:
// values > 1 decode at 1/denom resolution inside the IDCT (libjpeg
// scale_num/scale_denom) — much cheaper for large photos, NOT bit-identical
// to a full decode + resize (callers opt in explicitly).
// Error codes: 2 = libjpeg error, 3 = unsupported colorspace, 1 = alloc.
int decode_rgb(const uint8_t *data, unsigned long size, int scale_denom,
               uint8_t **outp, int *wp, int *hp) {
    jpeg_decompress_struct cinfo;
    ErrorMgr jerr;
    MemSource src;
    // volatile: read after longjmp (setjmp rule; libjpeg example.c does the same)
    uint8_t *volatile buf = nullptr;

    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = error_exit;
    jerr.pub.emit_message = emit_message;
    if (setjmp(jerr.setjmp_buffer)) {
        jpeg_destroy_decompress(&cinfo);
        free(buf);
        return 2;
    }
    jpeg_create_decompress(&cinfo);
    set_mem_source(&cinfo, &src, data, size);
    jpeg_read_header(&cinfo, TRUE);
    if (cinfo.jpeg_color_space != JCS_GRAYSCALE &&
        cinfo.jpeg_color_space != JCS_YCbCr &&
        cinfo.jpeg_color_space != JCS_RGB) {
        // CMYK/YCCK etc.: Pillow applies its own conversion; fall back.
        jpeg_destroy_decompress(&cinfo);
        return 3;
    }
    cinfo.out_color_space = JCS_RGB;
    if (scale_denom > 1) {
        cinfo.scale_num = 1;
        cinfo.scale_denom = (unsigned int)scale_denom;
    }
    // defaults match Pillow: ISLOW IDCT, fancy upsampling on.
    jpeg_start_decompress(&cinfo);
    int w = (int)cinfo.output_width;
    int h = (int)cinfo.output_height;
    if (w <= 0 || h <= 0 || cinfo.output_components != 3) {
        jpeg_destroy_decompress(&cinfo);
        return 2;
    }
    buf = (uint8_t *)malloc((size_t)w * h * 3);
    if (!buf) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW row = buf + (size_t)cinfo.output_scanline * w * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    long warnings = cinfo.err->num_warnings;
    jpeg_destroy_decompress(&cinfo);
    if (warnings > 0) {  // truncated/corrupt scan data: let PIL decide
        free(buf);
        return 2;
    }
    *outp = buf;
    *wp = w;
    *hp = h;
    return 0;
}

}  // namespace

extern "C" {

// Parse JPEG header only. Returns 0 and fills (*wp, *hp) on success.
int hst_jpeg_dims(const uint8_t *data, unsigned long size, int *wp, int *hp) {
    jpeg_decompress_struct cinfo;
    ErrorMgr jerr;
    MemSource src;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = error_exit;
    jerr.pub.emit_message = emit_message;
    if (setjmp(jerr.setjmp_buffer)) {
        jpeg_destroy_decompress(&cinfo);
        return 2;
    }
    jpeg_create_decompress(&cinfo);
    set_mem_source(&cinfo, &src, data, size);
    jpeg_read_header(&cinfo, TRUE);
    *wp = (int)cinfo.image_width;
    *hp = (int)cinfo.image_height;
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

// Decode -> resample to (tw, th) -> crop [top:top+ch, left:left+cw] into
// caller-allocated out (ch*cw*3 bytes). Crop offsets are computed by the
// Python caller (banker's rounding parity with load_image_staged).
// scale_denom = 1 is the bit-parity path; 2/4/8 decode at reduced IDCT
// resolution first (fast mode, approximate).
// Returns 0 success / 1 alloc / 2 jpeg error / 3 unsupported colorspace /
// 4 bad crop bounds.
int hst_decode_resize_crop(const uint8_t *data, unsigned long size, int tw,
                           int th, int left, int top, int cw, int ch,
                           int scale_denom, uint8_t *out) {
    if (tw <= 0 || th <= 0 || cw <= 0 || ch <= 0 || left < 0 || top < 0 ||
        left + cw > tw || top + ch > th) {
        return 4;
    }
    if (scale_denom != 1 && scale_denom != 2 && scale_denom != 4 &&
        scale_denom != 8) {
        return 4;
    }
    uint8_t *rgb;
    int w, h;
    int rc = decode_rgb(data, size, scale_denom, &rgb, &w, &h);
    if (rc) return rc;

    uint8_t *resized;
    rc = resample(rgb, w, h, tw, th, &resized);
    free(rgb);
    if (rc) return rc;

    for (int y = 0; y < ch; y++) {
        memcpy(out + (size_t)y * cw * 3,
               resized + ((size_t)(top + y) * tw + left) * 3, (size_t)cw * 3);
    }
    free(resized);
    return 0;
}

// Version/ABI tag so the Python side can cache-bust rebuilt binaries.
int hst_abi_version(void) { return 3; }

}  // extern "C"
