// Threaded host repacker: GGUF packed blocks -> the port's weight planes.
//
// The port's own copy of llama_cpp_test_tpu/native/ggufio.cpp, rewritten
// for the plane layout of llama_cpp_test_tpu_torch/quant/repack.py (the
// numpy repack, which stays the plain version the tests hold this one
// against, bit for bit). Types: Q8_0 and Q6_K (int8 planes), Q4_0, Q4_1
// and Q4_K (u4 planes with a min). Host C++ with std::thread; built by
// g++ at first use (native/__init__.py) and called through ctypes.
//
// Planes of an (N, K) weight, N padded to n_padded rows (zeros), pack
// values a byte (1 for int8, 2 for u4), npk = n_padded / pack, G = K /
// group:
//   layout 0 ("t", matmul weights): qs [K, npk] bytes; sub-value h of
//     qs[k, j] (bits [4h, 4h + 4) for u4) holds q[h * npk + j, k];
//     scale and min [pack, G, npk] as bf16 bit patterns (uint16, round to
//     nearest even from the f32 value).
//   layout 1 ("rows", embedding tables): qs [npk, K]; scale and min
//     [pack, G, npk] as f32.
// A weight is w = scale * q - min. Each thread owns a range of plane
// columns j, so no two threads write one byte; a tile of TJ columns is
// decoded into a buffer, then written out K-major.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

float f16_to_f32(uint16_t h) {
    uint32_t sign = (uint32_t)(h & 0x8000) << 16;
    uint32_t exp = (h >> 10) & 0x1F;
    uint32_t man = h & 0x3FF;
    uint32_t bits;
    if (exp == 0) {
        if (man == 0) {
            bits = sign;
        } else {  // subnormal: normalize
            exp = 127 - 15 + 1;
            while (!(man & 0x400)) { man <<= 1; exp--; }
            man &= 0x3FF;
            bits = sign | (exp << 23) | (man << 13);
        }
    } else if (exp == 31) {
        bits = sign | 0x7F800000u | (man << 13);
    } else {
        bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
    }
    float out;
    std::memcpy(&out, &bits, 4);
    return out;
}

uint16_t f32_to_bf16(float x) {
    // repack.f32_to_bf16_bits: (u + 0x7FFF + ((u >> 16) & 1)) >> 16
    uint32_t u;
    std::memcpy(&u, &x, 4);
    return (uint16_t)((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}

uint16_t rd16(const uint8_t* p) {
    uint16_t v;
    std::memcpy(&v, p, 2);
    return v;
}

// One row's decode: q[K] values (int8 or 0..15), s[G] and m[G] (m only
// for types with a min) as the numpy decomposers of quant/repack.py
// compute them.
typedef void (*row_decoder)(const uint8_t* src, int64_t k, int8_t* q,
                            float* s, float* m);

void dec_q8_0(const uint8_t* src, int64_t k, int8_t* q, float* s, float*) {
    for (int64_t b = 0; b < k / 32; b++) {
        const uint8_t* blk = src + b * 34;
        s[b] = f16_to_f32(rd16(blk));
        std::memcpy(q + b * 32, blk + 2, 32);
    }
}

void dec_q4_0(const uint8_t* src, int64_t k, int8_t* q, float* s, float* m) {
    for (int64_t b = 0; b < k / 32; b++) {
        const uint8_t* blk = src + b * 18;
        float d = f16_to_f32(rd16(blk));
        s[b] = d;
        m[b] = 8.0f * d;
        for (int i = 0; i < 16; i++) {
            q[b * 32 + i] = (int8_t)(blk[2 + i] & 0xF);
            q[b * 32 + 16 + i] = (int8_t)(blk[2 + i] >> 4);
        }
    }
}

void dec_q4_1(const uint8_t* src, int64_t k, int8_t* q, float* s, float* m) {
    for (int64_t b = 0; b < k / 32; b++) {
        const uint8_t* blk = src + b * 20;
        s[b] = f16_to_f32(rd16(blk));
        m[b] = -f16_to_f32(rd16(blk + 2));
        for (int i = 0; i < 16; i++) {
            q[b * 32 + i] = (int8_t)(blk[4 + i] & 0xF);
            q[b * 32 + 16 + i] = (int8_t)(blk[4 + i] >> 4);
        }
    }
}

// the 6-bit scale and min of group j of a Q4_K block (get_scale_min_k4)
void k4_scale_min(const uint8_t* q, int j, uint8_t& sc, uint8_t& m) {
    if (j < 4) {
        sc = q[j] & 63;
        m = q[j + 4] & 63;
    } else {
        sc = (q[j + 4] & 0xF) | ((q[j - 4] >> 6) << 4);
        m = (q[j + 4] >> 4) | ((q[j] >> 6) << 4);
    }
}

void dec_q4_k(const uint8_t* src, int64_t k, int8_t* q, float* s, float* m) {
    for (int64_t b = 0; b < k / 256; b++) {
        const uint8_t* blk = src + b * 144;
        float d = f16_to_f32(rd16(blk)), dmin = f16_to_f32(rd16(blk + 2));
        for (int g = 0; g < 8; g++) {
            uint8_t sc, mn;
            k4_scale_min(blk + 4, g, sc, mn);
            s[b * 8 + g] = d * (float)sc;
            m[b * 8 + g] = dmin * (float)mn;
        }
        // 4 chunks of 32 bytes; chunk c holds groups 2c (low nibbles) and
        // 2c + 1 (high nibbles)
        for (int c = 0; c < 4; c++) {
            const uint8_t* qq = blk + 16 + c * 32;
            int8_t* lo = q + b * 256 + c * 64;
            for (int i = 0; i < 32; i++) {
                lo[i] = (int8_t)(qq[i] & 0xF);
                lo[32 + i] = (int8_t)(qq[i] >> 4);
            }
        }
    }
}

void dec_q6_k(const uint8_t* src, int64_t k, int8_t* q, float* s, float*) {
    for (int64_t b = 0; b < k / 256; b++) {
        const uint8_t* blk = src + b * 210;
        const int8_t* sc = (const int8_t*)(blk + 192);
        float d = f16_to_f32(rd16(blk + 208));
        for (int g = 0; g < 16; g++) s[b * 16 + g] = d * (float)sc[g];
        for (int half = 0; half < 2; half++) {
            const uint8_t* l = blk + half * 64;
            const uint8_t* h = blk + 128 + half * 32;
            int8_t* out = q + b * 256 + half * 128;
            for (int i = 0; i < 32; i++) {
                out[i] = (int8_t)(((l[i] & 0xF) | (((h[i] >> 0) & 3) << 4)) - 32);
                out[32 + i] = (int8_t)(((l[32 + i] & 0xF) | (((h[i] >> 2) & 3) << 4)) - 32);
                out[64 + i] = (int8_t)(((l[i] >> 4) | (((h[i] >> 4) & 3) << 4)) - 32);
                out[96 + i] = (int8_t)(((l[32 + i] >> 4) | (((h[i] >> 6) & 3) << 4)) - 32);
            }
        }
    }
}

struct TypeInfo {
    row_decoder dec;
    int64_t block;      // values a block
    int64_t block_bytes;
    int64_t group;      // values a scale
    int pack;           // values a plane byte (1: int8, 2: u4)
    bool has_min;
};

// ggml type ids (gguf/constants.py GGMLType)
bool type_info(int ggml_type, TypeInfo& ti) {
    switch (ggml_type) {
        case 8:  ti = {dec_q8_0, 32, 34, 32, 1, false}; return true;
        case 2:  ti = {dec_q4_0, 32, 18, 32, 2, true}; return true;
        case 3:  ti = {dec_q4_1, 32, 20, 32, 2, true}; return true;
        case 12: ti = {dec_q4_k, 256, 144, 32, 2, true}; return true;
        case 14: ti = {dec_q6_k, 256, 210, 16, 1, false}; return true;
        default: return false;
    }
}

constexpr int64_t TJ = 64;   // plane columns a tile

struct Job {
    const uint8_t* src;
    TypeInfo ti;
    int64_t n, n_padded, k, row_bytes, npk, g;
    int layout;
    uint8_t* qs;
    void* scale;
    void* min_;
};

void write_plane(const Job& jb, void* plane, const std::vector<float>& t,
                 int64_t j0, int64_t tj) {
    // t: [pack][TJ][G] -> plane [pack, G, npk] at columns j0 .. j0 + tj
    for (int h = 0; h < jb.ti.pack; h++) {
        for (int64_t gi = 0; gi < jb.g; gi++) {
            int64_t base = (h * jb.g + gi) * jb.npk + j0;
            const float* col = t.data() + (int64_t)h * TJ * jb.g + gi;
            if (jb.layout == 0) {
                uint16_t* out = (uint16_t*)plane + base;
                for (int64_t jj = 0; jj < tj; jj++)
                    out[jj] = f32_to_bf16(col[jj * jb.g]);
            } else {
                float* out = (float*)plane + base;
                for (int64_t jj = 0; jj < tj; jj++) out[jj] = col[jj * jb.g];
            }
        }
    }
}

void run_tiles(const Job& jb, int64_t t_begin, int64_t t_end) {
    const int64_t k = jb.k, g = jb.g;
    const int pack = jb.ti.pack;
    std::vector<uint8_t> tile(TJ * k);
    std::vector<int8_t> q(k);
    std::vector<float> s((int64_t)pack * TJ * g), m((int64_t)pack * TJ * g);
    for (int64_t t = t_begin; t < t_end; t++) {
        int64_t j0 = t * TJ, tj = std::min(TJ, jb.npk - j0);
        // layout "rows" decodes straight into the plane's rows
        uint8_t* rows = jb.layout == 1 ? jb.qs + j0 * k : tile.data();
        std::memset(rows, 0, tj * k);
        std::fill(s.begin(), s.end(), 0.0f);
        std::fill(m.begin(), m.end(), 0.0f);
        for (int h = 0; h < pack; h++) {
            for (int64_t jj = 0; jj < tj; jj++) {
                int64_t r = h * jb.npk + j0 + jj;
                if (r >= jb.n) break;   // padding rows stay zero
                float* sr = s.data() + ((int64_t)h * TJ + jj) * g;
                float* mr = m.data() + ((int64_t)h * TJ + jj) * g;
                jb.ti.dec(jb.src + r * jb.row_bytes, k, q.data(), sr, mr);
                uint8_t* dst = rows + jj * k;
                if (pack == 1) {
                    std::memcpy(dst, q.data(), k);
                } else {
                    for (int64_t i = 0; i < k; i++)
                        dst[i] |= (uint8_t)((q[i] & 0xF) << (4 * h));
                }
            }
        }
        if (jb.layout == 0) {
            // [tj, K] tile -> qs [K, npk] columns j0 .. j0 + tj
            for (int64_t i = 0; i < k; i++) {
                uint8_t* out = jb.qs + i * jb.npk + j0;
                for (int64_t jj = 0; jj < tj; jj++) out[jj] = rows[jj * k + i];
            }
        }
        write_plane(jb, jb.scale, s, j0, tj);
        if (jb.min_) write_plane(jb, jb.min_, m, j0, tj);
    }
}

}  // namespace

extern "C" {

// 1 if this ggml type has a native repack, else 0.
int ggufio_supports(int ggml_type) {
    TypeInfo ti;
    return type_info(ggml_type, ti) ? 1 : 0;
}

// Repack n rows of packed GGUF bytes (row length k values) into planes
// the caller allocated (every byte is written, padding included):
//   qs     layout 0: [k, n_padded / pack]; layout 1: [n_padded / pack, k]
//   scale  [pack, k / group, n_padded / pack]: uint16 bf16 bits (layout
//          0) or f32 (layout 1); min_ the same, or null for Q8_0/Q6_K.
// Returns 0, or -1 for an unsupported type, -2 for bad sizes.
int ggufio_repack(int ggml_type, const uint8_t* src, int64_t n,
                  int64_t n_padded, int64_t k, int layout, uint8_t* qs,
                  void* scale, void* min_, int n_threads) {
    TypeInfo ti;
    if (!type_info(ggml_type, ti)) return -1;
    if (k % ti.block || n_padded < n || n_padded % ti.pack ||
        (layout != 0 && layout != 1) || (ti.has_min != (min_ != nullptr)))
        return -2;
    Job jb{src, ti, n, n_padded, k, (k / ti.block) * ti.block_bytes,
           n_padded / ti.pack, k / ti.group, layout, qs, scale, min_};
    int64_t tiles = (jb.npk + TJ - 1) / TJ;
    int64_t nt = std::max<int64_t>(1, std::min<int64_t>(n_threads, tiles));
    if (nt == 1) {
        run_tiles(jb, 0, tiles);
        return 0;
    }
    std::vector<std::thread> ts;
    int64_t per = (tiles + nt - 1) / nt;
    for (int64_t t = 0; t < nt; t++) {
        int64_t a = t * per, b = std::min(tiles, (t + 1) * per);
        if (a < b) ts.emplace_back(run_tiles, std::cref(jb), a, b);
    }
    for (auto& th : ts) th.join();
    return 0;
}

}  // extern "C"
