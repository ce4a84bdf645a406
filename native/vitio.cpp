// vitio — native host-side runtime for viterbi_tpu.
//
// The analog of the reference DLL's host-side native layer
// (lifecycle, buffer plumbing, harness encoder — dllmain.cpp,
// viterbi-benchmark.cpp of the reference). The accelerator decodes;
// this library keeps the host side off the Python interpreter's critical
// path: bit-true encoding for fixture/loopback generation, MSB-first bit
// packing, superframe (de)interleaving, generic depuncturing, and a
// thread-safe frame ring buffer that assembles fixed-size decode batches
// from concurrent producers (the analog of QIRX's multi-threaded calls
// into the DLL, README.md:56).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <condition_variable>
#include <mutex>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// K=7 rate-1/4 convolutional encoder (viterbi-benchmark.cpp:303-311)
// bits: framebits entries of 0/1. out: 4*(framebits+6) hard symbols 0/1.
// ---------------------------------------------------------------------
static const unsigned kPolys[4] = {109, 79, 83, 109};

void vit_encode(const uint8_t* bits, int framebits, uint8_t* out) {
    unsigned sr = 0;
    int total = framebits + 6;
    for (int i = 0; i < total; i++) {
        unsigned bit = (i < framebits) ? (bits[i] & 1) : 0;
        sr = ((sr << 1) | bit) & 0x7F;
        for (int j = 0; j < 4; j++)
            out[4 * i + j] = (uint8_t)__builtin_parity(sr & kPolys[j]);
    }
}

// Map hard symbols to ideal soft u32 symbols (0 -> 0, 1 -> 255).
void vit_hard_to_soft(const uint8_t* hard, int n, uint32_t* out) {
    for (int i = 0; i < n; i++) out[i] = hard[i] ? 255u : 0u;
}

// ---------------------------------------------------------------------
// MSB-first bit packing (the output format of deconvolve's chainback)
// ---------------------------------------------------------------------
void vit_pack_bits(const uint8_t* bits, int nbits, uint8_t* out) {
    int nbytes = (nbits + 7) / 8;
    memset(out, 0, (size_t)nbytes);
    for (int i = 0; i < nbits; i++)
        out[i >> 3] |= (uint8_t)((bits[i] & 1) << (7 - (i & 7)));
}

void vit_unpack_bits(const uint8_t* bytes, int nbits, uint8_t* out) {
    for (int i = 0; i < nbits; i++)
        out[i] = (bytes[i >> 3] >> (7 - (i & 7))) & 1;
}

// ---------------------------------------------------------------------
// DAB+ superframe byte (de)interleave (rschecksf.cpp:74-83):
// codeword j's byte k lives at p[j + k*rs_dims].
// ---------------------------------------------------------------------
void vit_rs_deinterleave(const uint8_t* p, int rs_dims, int word_len,
                         uint8_t* out /* [rs_dims][word_len] */) {
    for (int j = 0; j < rs_dims; j++)
        for (int k = 0; k < word_len; k++)
            out[j * word_len + k] = p[j + k * rs_dims];
}

void vit_rs_interleave(const uint8_t* blocks, int rs_dims, int word_len,
                       uint8_t* out) {
    for (int j = 0; j < rs_dims; j++)
        for (int k = 0; k < word_len; k++)
            out[j + k * rs_dims] = blocks[j * word_len + k];
}

// ---------------------------------------------------------------------
// Generic depuncture: expand a punctured soft-symbol stream to the full
// rate-1/4 mother-code stream, inserting a neutral fill value where the
// mask is 0. (QIRX performs DAB depuncturing upstream of the reference
// DLL — SURVEY.md §2.1 — this utility lets viterbi_tpu ingest punctured
// streams directly.) mask: mask_len entries of 0/1, tiled cyclically.
// Returns the number of input symbols consumed.
// ---------------------------------------------------------------------
int vit_depuncture(const uint32_t* in, int n_in, const uint8_t* mask,
                   int mask_len, int n_out, uint32_t fill, uint32_t* out) {
    int src = 0;
    for (int i = 0; i < n_out; i++) {
        if (mask[i % mask_len]) {
            out[i] = (src < n_in) ? in[src] : fill;
            src++;
        } else {
            out[i] = fill;
        }
    }
    return src < n_in ? src : n_in;
}

// ---------------------------------------------------------------------
// Frame ring buffer: concurrent producers push variable frames; a
// consumer pops fixed-size batches for device dispatch. The scheduler
// analog of the reference's re-entrant multi-threaded entry points.
// ---------------------------------------------------------------------
struct VitRing {
    std::mutex mu;
    std::condition_variable cv;
    std::vector<uint32_t> data;   // capacity * frame_len
    std::vector<int64_t> tags;
    int frame_len = 0, capacity = 0, head = 0, tail = 0, count = 0;
    bool closed = false;
};

void* vit_ring_create(int capacity, int frame_len) {
    VitRing* r = new VitRing();
    r->frame_len = frame_len;
    r->capacity = capacity;
    r->data.resize((size_t)capacity * frame_len);
    r->tags.resize(capacity);
    return r;
}

void vit_ring_destroy(void* h) { delete (VitRing*)h; }

void vit_ring_close(void* h) {
    VitRing* r = (VitRing*)h;
    std::lock_guard<std::mutex> lk(r->mu);
    r->closed = true;
    r->cv.notify_all();
}

// Push one frame; blocks while full. Returns 0 ok, -1 if closed.
int vit_ring_push(void* h, const uint32_t* frame, int64_t tag) {
    VitRing* r = (VitRing*)h;
    std::unique_lock<std::mutex> lk(r->mu);
    r->cv.wait(lk, [&] { return r->count < r->capacity || r->closed; });
    if (r->closed) return -1;
    memcpy(&r->data[(size_t)r->tail * r->frame_len], frame,
           (size_t)r->frame_len * sizeof(uint32_t));
    r->tags[r->tail] = tag;
    r->tail = (r->tail + 1) % r->capacity;
    r->count++;
    r->cv.notify_all();
    return 0;
}

// Pop up to `batch` frames into out (contiguous [batch][frame_len]) and
// their tags. Blocks until at least `min_batch` frames are available or
// the ring is closed. Returns the number of frames popped (0 on closed
// and drained).
int vit_ring_pop_batch(void* h, int batch, int min_batch, uint32_t* out,
                       int64_t* tags_out) {
    VitRing* r = (VitRing*)h;
    std::unique_lock<std::mutex> lk(r->mu);
    r->cv.wait(lk, [&] { return r->count >= min_batch || r->closed; });
    int n = r->count < batch ? r->count : batch;
    for (int i = 0; i < n; i++) {
        memcpy(out + (size_t)i * r->frame_len,
               &r->data[(size_t)r->head * r->frame_len],
               (size_t)r->frame_len * sizeof(uint32_t));
        tags_out[i] = r->tags[r->head];
        r->head = (r->head + 1) % r->capacity;
        r->count--;
    }
    if (n) r->cv.notify_all();
    return n;
}

int vit_ring_size(void* h) {
    VitRing* r = (VitRing*)h;
    std::lock_guard<std::mutex> lk(r->mu);
    return r->count;
}

// Library self-identification for the capability probe.
int vitio_version() { return 1; }

}  // extern "C"
