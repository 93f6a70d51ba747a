// Native runtime components of the PyTorch port, exposed through a C ABI
// for ctypes (pocket_tts_tpu_torch/native.py builds and binds it):
//   - safetensors header parse + mmap tensor access
//   - a streaming sentence splitter, exact against the pure-Python
//     text.preprocess.StrProcessor: it walks UTF-8 code points and takes
//     whitespace, upper case and alphanumerics from `unicode_tables.h`,
//     which native.py generates from the building Python's own `str`
//     methods
//   - WAV writing (16-bit mono PCM)
//   - a thread-safe PCM FIFO for realtime playback and serving
//
// The compute path stays in PyTorch and the CUDA kernels; these cover
// host-side I/O and streaming bookkeeping.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <vector>

#include "unicode_tables.h"

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#define API extern "C" __attribute__((visibility("default")))

// ===========================================================================
// minimal JSON scanner for the safetensors header (objects/strings/numbers)
// ===========================================================================

namespace stj {

struct Cursor {
    const char* p;
    const char* end;
    bool ok = true;

    void skip_ws() { while (p < end && isspace((unsigned char)*p)) p++; }
    bool eat(char c) {
        skip_ws();
        if (p < end && *p == c) { p++; return true; }
        ok = false;
        return false;
    }
    bool peek(char c) { skip_ws(); return p < end && *p == c; }

    std::string parse_string() {
        skip_ws();
        std::string out;
        if (p >= end || *p != '"') { ok = false; return out; }
        p++;
        while (p < end && *p != '"') {
            if (*p == '\\' && p + 1 < end) { p++; }
            out += *p++;
        }
        if (p < end) p++;  // closing quote
        return out;
    }
    int64_t parse_int() {
        skip_ws();
        char* q = nullptr;
        int64_t v = strtoll(p, &q, 10);
        if (q == p) ok = false;
        p = q;
        return v;
    }
    void skip_value();  // skip any JSON value
};

void Cursor::skip_value() {
    skip_ws();
    if (p >= end) { ok = false; return; }
    if (*p == '"') { parse_string(); return; }
    if (*p == '{') {
        p++;
        if (peek('}')) { p++; return; }
        while (ok) {
            parse_string(); eat(':'); skip_value();
            if (peek(',')) { p++; continue; }
            eat('}'); break;
        }
        return;
    }
    if (*p == '[') {
        p++;
        if (peek(']')) { p++; return; }
        while (ok) {
            skip_value();
            if (peek(',')) { p++; continue; }
            eat(']'); break;
        }
        return;
    }
    // number / literal
    while (p < end && !strchr(",}] \t\r\n", *p)) p++;
}

}  // namespace stj

// ===========================================================================
// safetensors file
// ===========================================================================

struct StTensor {
    std::string name;
    std::string dtype;
    std::vector<int64_t> shape;
    uint64_t begin = 0, end = 0;  // relative to data section
};

struct StFile {
    int fd = -1;
    void* map = MAP_FAILED;
    size_t size = 0;
    uint64_t data_off = 0;
    std::vector<StTensor> tensors;
};

API void* st_open(const char* path) {
    auto* f = new StFile();
    f->fd = open(path, O_RDONLY);
    if (f->fd < 0) { delete f; return nullptr; }
    struct stat st;
    if (fstat(f->fd, &st) != 0 || st.st_size < 8) {
        close(f->fd); delete f; return nullptr;
    }
    f->size = (size_t)st.st_size;
    f->map = mmap(nullptr, f->size, PROT_READ, MAP_SHARED, f->fd, 0);
    if (f->map == MAP_FAILED) { close(f->fd); delete f; return nullptr; }

    uint64_t hlen;
    memcpy(&hlen, f->map, 8);
    if (8 + hlen > f->size) { goto fail; }
    {
        const char* h = (const char*)f->map + 8;
        stj::Cursor c{h, h + hlen};
        if (!c.eat('{')) goto fail;
        if (c.peek('}')) { c.p++; }
        else while (c.ok) {
            std::string name = c.parse_string();
            c.eat(':');
            if (name == "__metadata__") {
                c.skip_value();
            } else {
                StTensor t;
                t.name = name;
                if (!c.eat('{')) goto fail;
                while (c.ok) {
                    std::string key = c.parse_string();
                    c.eat(':');
                    if (key == "dtype") {
                        t.dtype = c.parse_string();
                    } else if (key == "shape") {
                        c.eat('[');
                        if (c.peek(']')) { c.p++; }
                        else while (c.ok) {
                            t.shape.push_back(c.parse_int());
                            if (c.peek(',')) { c.p++; continue; }
                            c.eat(']'); break;
                        }
                    } else if (key == "data_offsets") {
                        c.eat('[');
                        t.begin = (uint64_t)c.parse_int();
                        c.eat(',');
                        t.end = (uint64_t)c.parse_int();
                        c.eat(']');
                    } else {
                        c.skip_value();
                    }
                    if (c.peek(',')) { c.p++; continue; }
                    c.eat('}'); break;
                }
                f->tensors.push_back(std::move(t));
            }
            if (c.peek(',')) { c.p++; continue; }
            c.eat('}'); break;
        }
        if (!c.ok) goto fail;
    }
    f->data_off = 8 + hlen;
    return f;
fail:
    munmap(f->map, f->size);
    close(f->fd);
    delete f;
    return nullptr;
}

API void st_close(void* h) {
    auto* f = (StFile*)h;
    if (!f) return;
    if (f->map != MAP_FAILED) munmap(f->map, f->size);
    if (f->fd >= 0) close(f->fd);
    delete f;
}

API int64_t st_num_tensors(void* h) { return (int64_t)((StFile*)h)->tensors.size(); }

API const char* st_name(void* h, int64_t i) {
    return ((StFile*)h)->tensors[(size_t)i].name.c_str();
}
API const char* st_dtype(void* h, int64_t i) {
    return ((StFile*)h)->tensors[(size_t)i].dtype.c_str();
}
API int64_t st_ndim(void* h, int64_t i) {
    return (int64_t)((StFile*)h)->tensors[(size_t)i].shape.size();
}
API void st_shape(void* h, int64_t i, int64_t* out) {
    auto& s = ((StFile*)h)->tensors[(size_t)i].shape;
    for (size_t d = 0; d < s.size(); d++) out[d] = s[d];
}
API const void* st_data(void* h, int64_t i, int64_t* nbytes) {
    auto* f = (StFile*)h;
    auto& t = f->tensors[(size_t)i];
    if (t.end > f->size - f->data_off || t.begin > t.end) return nullptr;
    *nbytes = (int64_t)(t.end - t.begin);
    return (const char*)f->map + f->data_off + t.begin;
}

// ===========================================================================
// streaming sentence splitter (str_processor_t port)
// ===========================================================================

struct StrProc {
    std::string tail;
    std::deque<std::string> sentences;
    bool was_ws = true, was_eos = false, leading = true;
};

static bool is_eos(uint32_t c) { return c == '.' || c == '!' || c == '?'; }

template <size_t N>
static bool in_ranges(const uint32_t (&r)[N][2], uint32_t c) {
    size_t lo = 0, hi = N;
    while (lo < hi) {
        size_t mid = (lo + hi) / 2;
        if (c < r[mid][0]) hi = mid;
        else if (c > r[mid][1]) lo = mid + 1;
        else return true;
    }
    return false;
}

static const char* upper_of(uint32_t c) {
    size_t lo = 0, hi = sizeof(kUpper) / sizeof(kUpper[0]);
    while (lo < hi) {
        size_t mid = (lo + hi) / 2;
        if (c < kUpper[mid].cp) hi = mid;
        else if (c > kUpper[mid].cp) lo = mid + 1;
        else return kUpper[mid].utf8;
    }
    return nullptr;
}

// One UTF-8 code point starting at p (n bytes left): its value and its
// length in bytes. A malformed byte stands for itself, one byte long.
static uint32_t decode_utf8(const unsigned char* p, int64_t n, int* len) {
    unsigned b = p[0];
    int k = b < 0x80 ? 1 : (b >> 5) == 6 ? 2 : (b >> 4) == 14 ? 3
            : (b >> 3) == 30 ? 4 : 0;
    if (k == 0 || k > n) { *len = 1; return b; }
    uint32_t c = k == 1 ? b : b & (0x7F >> k);
    for (int i = 1; i < k; i++) {
        if ((p[i] & 0xC0) != 0x80) { *len = 1; return b; }
        c = (c << 6) | (p[i] & 0x3F);
    }
    *len = k;
    return c;
}

API void* sp_new() { return new StrProc(); }
API void sp_free(void* h) { delete (StrProc*)h; }

API void sp_reset(void* h) {
    auto* s = (StrProc*)h;
    s->tail.clear();
    s->sentences.clear();
    s->was_ws = true; s->was_eos = false; s->leading = true;
}

// chunk: n bytes of UTF-8 (whole code points: the binding encodes each
// Python str chunk on its own)
API void sp_ingest(void* h, const char* chunk, int64_t n) {
    auto* s = (StrProc*)h;
    const unsigned char* p = (const unsigned char*)chunk;
    for (int64_t i = 0; i < n;) {
        int len;
        uint32_t c = decode_utf8(p + i, n - i, &len);
        bool eos = is_eos(c);
        if (!eos && s->was_eos) {
            s->sentences.push_back(s->tail);
            s->tail.clear();
            s->was_ws = true;
            s->leading = true;
        }
        bool ws = in_ranges(kSpace, c);
        if (ws && !s->was_ws) {
            s->tail += ' ';
        } else if (!ws) {
            const char* up = s->leading ? upper_of(c) : nullptr;
            if (up) s->tail += up;
            else s->tail.append((const char*)p + i, (size_t)len);
            s->leading = false;
        }
        s->was_ws = ws;
        s->was_eos = eos;
        i += len;
    }
}

API void sp_flush(void* h) {
    auto* s = (StrProc*)h;
    if (!s->tail.empty()) {
        // the last code point: back over UTF-8 continuation bytes
        size_t i = s->tail.size() - 1;
        while (i > 0 && ((unsigned char)s->tail[i] & 0xC0) == 0x80) i--;
        int len;
        uint32_t c = decode_utf8((const unsigned char*)s->tail.data() + i,
                                 (int64_t)(s->tail.size() - i), &len);
        if (in_ranges(kAlnum, c)) s->tail += '.';
        s->sentences.push_back(s->tail);
        s->tail.clear();
    }
    s->was_ws = true; s->was_eos = false; s->leading = true;
}

API int64_t sp_count(void* h) { return (int64_t)((StrProc*)h)->sentences.size(); }

// bytes of the front sentence, or -1 if none is ready
API int64_t sp_front_size(void* h) {
    auto* s = (StrProc*)h;
    return s->sentences.empty() ? -1 : (int64_t)s->sentences.front().size();
}

// copies the front sentence into buf (cap bytes incl nul); returns length or
// -1 if empty
API int64_t sp_pop(void* h, char* buf, int64_t cap) {
    auto* s = (StrProc*)h;
    if (s->sentences.empty()) return -1;
    std::string& front = s->sentences.front();
    int64_t n = (int64_t)front.size();
    if (n + 1 > cap) return -2;
    memcpy(buf, front.c_str(), (size_t)n + 1);
    s->sentences.pop_front();
    return n;
}

// ===========================================================================
// WAV write/read (16-bit mono PCM)
// ===========================================================================

#pragma pack(push, 1)
struct WavHeader {
    char riff[4]; uint32_t size; char wave[4];
    char fmt[4]; uint32_t fmt_size;
    uint16_t audio_format, channels;
    uint32_t sample_rate, byte_rate;
    uint16_t block_align, bits;
    char data[4]; uint32_t data_size;
};
#pragma pack(pop)

API int wav_write(const char* path, const float* samples, int64_t n,
                  int sample_rate) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    WavHeader h;
    memcpy(h.riff, "RIFF", 4); memcpy(h.wave, "WAVE", 4);
    memcpy(h.fmt, "fmt ", 4); memcpy(h.data, "data", 4);
    h.fmt_size = 16; h.audio_format = 1; h.channels = 1;
    h.sample_rate = (uint32_t)sample_rate;
    h.byte_rate = (uint32_t)sample_rate * 2;
    h.block_align = 2; h.bits = 16;
    h.data_size = (uint32_t)(n * 2);
    h.size = h.data_size + (uint32_t)sizeof(WavHeader) - 8;
    fwrite(&h, sizeof(h), 1, f);
    std::vector<int16_t> buf((size_t)n);
    for (int64_t i = 0; i < n; i++) {
        float v = samples[i];
        v = v < -1.f ? -1.f : (v > 1.f ? 1.f : v);
        buf[(size_t)i] = (int16_t)(v * 32767.f);
    }
    fwrite(buf.data(), 2, (size_t)n, f);
    fclose(f);
    return 0;
}

// ===========================================================================
// PCM ring FIFO (thread-safe) for realtime serving
// ===========================================================================

struct PcmFifo {
    std::mutex mu;
    std::vector<float> buf;
    size_t head = 0, count = 0;
};

API void* fifo_new(int64_t capacity) {
    auto* f = new PcmFifo();
    f->buf.resize((size_t)capacity);
    return f;
}
API void fifo_free(void* h) { delete (PcmFifo*)h; }

API int64_t fifo_push(void* h, const float* data, int64_t n) {
    auto* f = (PcmFifo*)h;
    std::lock_guard<std::mutex> lock(f->mu);
    size_t cap = f->buf.size();
    size_t can = cap - f->count;
    size_t todo = (size_t)n < can ? (size_t)n : can;
    for (size_t i = 0; i < todo; i++)
        f->buf[(f->head + f->count + i) % cap] = data[i];
    f->count += todo;
    return (int64_t)todo;
}

API int64_t fifo_pop(void* h, float* out, int64_t n) {
    auto* f = (PcmFifo*)h;
    std::lock_guard<std::mutex> lock(f->mu);
    size_t cap = f->buf.size();
    size_t todo = (size_t)n < f->count ? (size_t)n : f->count;
    for (size_t i = 0; i < todo; i++) out[i] = f->buf[(f->head + i) % cap];
    f->head = (f->head + todo) % cap;
    f->count -= todo;
    return (int64_t)todo;
}

API int64_t fifo_size(void* h) {
    auto* f = (PcmFifo*)h;
    std::lock_guard<std::mutex> lock(f->mu);
    return (int64_t)f->count;
}
