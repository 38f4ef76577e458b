// Dataset ingest (C ABI, loaded through ctypes by data/native_ingest.py):
// the port's own copy of exemplar_vae_tpu/native/ingest.cc.
//
// A streaming parser of the Larochelle fixed-binarization MNIST .amat text
// files (one pass over the file, 0/1 tokens without strtof) and an IDX
// (MNIST-ubyte) reader.
// data/native_ingest.py builds it with g++ at first use and raises if the
// build or the load fails; it parses with numpy only where the format asks
// for it (a gzipped file, or a file this parser rejects).
//
// Build: g++ -O3 -shared -fPIC ingest.cc -o libingest.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Parse a whitespace-separated text matrix of 0/1 (or small floats) values.
// Writes up to max_elems float32 into out; returns the number of values
// parsed, or -1 on I/O error. Handles arbitrary whitespace/newlines.
long amat_parse(const char* path, float* out, long max_elems) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    // stream in 1 MiB chunks; values are short tokens, keep a small carry
    static const size_t BUF = 1 << 20;
    char* buf = static_cast<char*>(std::malloc(BUF + 64));
    if (!buf) { std::fclose(f); return -1; }
    long n = 0;
    size_t carry = 0;
    while (true) {
        size_t got = std::fread(buf + carry, 1, BUF, f);
        size_t len = carry + got;
        if (len == 0) break;
        size_t pos = 0;
        size_t last_token_end = 0;
        while (pos < len) {
            // skip whitespace
            while (pos < len && (buf[pos] == ' ' || buf[pos] == '\n' ||
                                 buf[pos] == '\r' || buf[pos] == '\t'))
                pos++;
            size_t start = pos;
            while (pos < len && buf[pos] != ' ' && buf[pos] != '\n' &&
                   buf[pos] != '\r' && buf[pos] != '\t')
                pos++;
            if (pos == len && got == BUF) {
                // token may continue in the next chunk — carry it over
                carry = len - start;
                if (carry > 63) {
                    // only 64 bytes of slack beyond BUF: a longer carried
                    // token would overflow the next fread(buf+carry,...).
                    // No real .amat value is this long: report the file as
                    // malformed and let the caller parse it with numpy.
                    std::free(buf);
                    std::fclose(f);
                    return -1;
                }
                std::memmove(buf, buf + start, carry);
                goto next_chunk;
            }
            if (pos > start) {
                if (n >= max_elems) { std::free(buf); std::fclose(f); return n; }
                // fast path: single-char 0/1 tokens dominate these files
                if (pos - start == 1 && (buf[start] == '0' || buf[start] == '1')) {
                    out[n++] = static_cast<float>(buf[start] - '0');
                } else {
                    char save = buf[pos < len ? pos : len - 1];
                    buf[pos] = '\0';
                    out[n++] = std::strtof(buf + start, nullptr);
                    buf[pos] = save;
                }
                last_token_end = pos;
            }
        }
        carry = 0;
        (void)last_token_end;
    next_chunk:
        if (got < BUF) {
            // EOF: flush any carried final token
            if (carry > 0 && n < max_elems) {
                buf[carry] = '\0';
                out[n++] = std::strtof(buf, nullptr);
            }
            break;
        }
    }
    std::free(buf);
    std::fclose(f);
    return n;
}

// Read an IDX (MNIST-ubyte) file: returns ndim and fills dims (max 4) and
// copies payload bytes into out (up to max_bytes). Returns payload size or
// -1 on error/magic mismatch.
long idx_parse(const char* path, int* ndim_out, long* dims_out,
               uint8_t* out, long max_bytes) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    uint8_t hdr[4];
    if (std::fread(hdr, 1, 4, f) != 4 || hdr[0] != 0 || hdr[1] != 0) {
        std::fclose(f); return -1;
    }
    // dtype code must be 0x08 (unsigned byte): any other IDX dtype would
    // be silently parsed as uint8 garbage (total=prod(dims) bytes of a
    // payload elem_size x larger) — the python fallback raises on the
    // reshape instead, and the fast path must not be more permissive
    if (hdr[2] != 0x08) { std::fclose(f); return -1; }
    int ndim = hdr[3];
    if (ndim < 1 || ndim > 4) { std::fclose(f); return -1; }
    long total = 1;
    for (int i = 0; i < ndim; i++) {
        uint8_t d[4];
        if (std::fread(d, 1, 4, f) != 4) { std::fclose(f); return -1; }
        long v = (long(d[0]) << 24) | (long(d[1]) << 16) |
                 (long(d[2]) << 8) | long(d[3]);
        dims_out[i] = v;
        total *= v;
    }
    *ndim_out = ndim;
    if (out == nullptr) { std::fclose(f); return total; }  // size query
    long want = total < max_bytes ? total : max_bytes;
    long got = static_cast<long>(std::fread(out, 1, want, f));
    std::fclose(f);
    return got;
}

}  // extern "C"
