// Bit-packed Aaronson-Gottesman CHP tableau engine.
//
// Fills the role stim (C++) plays behind the reference's StabilizerCircuit
// (reference stabilizercircuit.py:7) — the rebuild cannot ride stim, so this
// is a self-built engine: 64-qubit-per-word packed X/Z planes, bit-parallel
// rowsum phase accumulation via popcount masks, O(n^2/64) measurements.
// Loaded via ctypes (core/native_tableau.py); semantics mirror the pure
// numpy engine in core/tableau.py (cross-checked by tests).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libtableau.so tableau.cpp

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

struct Tab {
    int n;       // qubits
    int W;       // words per row
    uint64_t* x; // (2n+1) x W  (row 2n = scratch)
    uint64_t* z;
    uint8_t* r;  // 2n+1 sign bits
};

inline uint64_t* row_x(Tab* t, int i) { return t->x + (size_t)i * t->W; }
inline uint64_t* row_z(Tab* t, int i) { return t->z + (size_t)i * t->W; }

inline int get_bit(const uint64_t* row, int q) {
    return (int)((row[q >> 6] >> (q & 63)) & 1ull);
}
inline void set_bit(uint64_t* row, int q, int v) {
    uint64_t m = 1ull << (q & 63);
    if (v) row[q >> 6] |= m; else row[q >> 6] &= ~m;
}
inline void xor_bit(uint64_t* row, int q, int v) {
    if (v) row[q >> 6] ^= 1ull << (q & 63);
}

// phase-exponent contribution of row i multiplied onto row h, mod 4
// (bit-parallel version of the CHP g-function; see core/tableau.py:_g)
inline long rowsum_phase(Tab* t, int h, int i) {
    const uint64_t* xi = row_x(t, i);
    const uint64_t* zi = row_z(t, i);
    const uint64_t* xh = row_x(t, h);
    const uint64_t* zh = row_z(t, h);
    long plus = 0, minus = 0;
    for (int w = 0; w < t->W; ++w) {
        uint64_t a = xi[w], b = zi[w], c = xh[w], d = zh[w];
        // +1: (1,1,0,1) (1,0,1,1) (0,1,1,0)
        uint64_t p = (a & b & ~c & d) | (a & ~b & c & d) | (~a & b & c & ~d);
        // -1: (1,1,1,0) (1,0,0,1) (0,1,1,1)
        uint64_t m = (a & b & c & ~d) | (a & ~b & ~c & d) | (~a & b & c & d);
        plus += __builtin_popcountll(p);
        minus += __builtin_popcountll(m);
    }
    return plus - minus;
}

inline void rowsum(Tab* t, int h, int i) {
    long phase = 2L * ((long)t->r[h] + (long)t->r[i]) + rowsum_phase(t, h, i);
    phase %= 4; if (phase < 0) phase += 4;
    t->r[h] = (uint8_t)(phase / 2);
    uint64_t* xh = row_x(t, h);
    uint64_t* zh = row_z(t, h);
    const uint64_t* xi = row_x(t, i);
    const uint64_t* zi = row_z(t, i);
    for (int w = 0; w < t->W; ++w) { xh[w] ^= xi[w]; zh[w] ^= zi[w]; }
}

inline uint64_t xorshift64(uint64_t& s) {
    s ^= s << 13; s ^= s >> 7; s ^= s << 17; return s;
}

} // namespace

extern "C" {

void* tab_new(int n) {
    Tab* t = new Tab;
    t->n = n;
    t->W = (n + 63) / 64;
    size_t rows = (size_t)(2 * n + 1);
    t->x = (uint64_t*)calloc(rows * t->W, sizeof(uint64_t));
    t->z = (uint64_t*)calloc(rows * t->W, sizeof(uint64_t));
    t->r = (uint8_t*)calloc(rows, 1);
    for (int i = 0; i < n; ++i) {
        set_bit(row_x(t, i), i, 1);          // destabilizer X_i
        set_bit(row_z(t, n + i), i, 1);      // stabilizer Z_i
    }
    return t;
}

void tab_free(void* h) {
    Tab* t = (Tab*)h;
    free(t->x); free(t->z); free(t->r);
    delete t;
}

void* tab_copy(void* h) {
    Tab* s = (Tab*)h;
    Tab* t = new Tab;
    t->n = s->n; t->W = s->W;
    size_t rows = (size_t)(2 * s->n + 1);
    t->x = (uint64_t*)malloc(rows * t->W * sizeof(uint64_t));
    t->z = (uint64_t*)malloc(rows * t->W * sizeof(uint64_t));
    t->r = (uint8_t*)malloc(rows);
    memcpy(t->x, s->x, rows * t->W * sizeof(uint64_t));
    memcpy(t->z, s->z, rows * t->W * sizeof(uint64_t));
    memcpy(t->r, s->r, rows);
    return t;
}

// gate codes: 0 h, 1 s, 2 sd, 3 x, 4 y, 5 z, 6 sx, 7 cnot, 8 cz, 9 cy,
// 10 swap, 11 iswap
void tab_gate(void* hd, int code, int a, int b) {
    Tab* t = (Tab*)hd;
    int rows = 2 * t->n;
    switch (code) {
    case 0: // h
        for (int i = 0; i < rows; ++i) {
            int xb = get_bit(row_x(t, i), a), zb = get_bit(row_z(t, i), a);
            t->r[i] ^= (uint8_t)(xb & zb);
            set_bit(row_x(t, i), a, zb);
            set_bit(row_z(t, i), a, xb);
        }
        break;
    case 1: // s
        for (int i = 0; i < rows; ++i) {
            int xb = get_bit(row_x(t, i), a), zb = get_bit(row_z(t, i), a);
            t->r[i] ^= (uint8_t)(xb & zb);
            xor_bit(row_z(t, i), a, xb);
        }
        break;
    case 2: // sd = s s s
        tab_gate(hd, 1, a, -1); tab_gate(hd, 1, a, -1); tab_gate(hd, 1, a, -1);
        break;
    case 3: // x
        for (int i = 0; i < rows; ++i) t->r[i] ^= (uint8_t)get_bit(row_z(t, i), a);
        break;
    case 4: // y
        for (int i = 0; i < rows; ++i)
            t->r[i] ^= (uint8_t)(get_bit(row_x(t, i), a) ^ get_bit(row_z(t, i), a));
        break;
    case 5: // z
        for (int i = 0; i < rows; ++i) t->r[i] ^= (uint8_t)get_bit(row_x(t, i), a);
        break;
    case 6: // sx = h s h
        tab_gate(hd, 0, a, -1); tab_gate(hd, 1, a, -1); tab_gate(hd, 0, a, -1);
        break;
    case 7: // cnot(a control, b target)
        for (int i = 0; i < rows; ++i) {
            int xc = get_bit(row_x(t, i), a), zc = get_bit(row_z(t, i), a);
            int xt = get_bit(row_x(t, i), b), zt = get_bit(row_z(t, i), b);
            t->r[i] ^= (uint8_t)(xc & zt & (xt ^ zc ^ 1));
            set_bit(row_x(t, i), b, xt ^ xc);
            set_bit(row_z(t, i), a, zc ^ zt);
        }
        break;
    case 8: // cz = h(b) cnot h(b)
        tab_gate(hd, 0, b, -1); tab_gate(hd, 7, a, b); tab_gate(hd, 0, b, -1);
        break;
    case 9: // cy = sd(b) cnot s(b)
        tab_gate(hd, 2, b, -1); tab_gate(hd, 7, a, b); tab_gate(hd, 1, b, -1);
        break;
    case 10: // swap
        tab_gate(hd, 7, a, b); tab_gate(hd, 7, b, a); tab_gate(hd, 7, a, b);
        break;
    case 11: // iswap = swap cz s(a) s(b)
        tab_gate(hd, 10, a, b); tab_gate(hd, 8, a, b);
        tab_gate(hd, 1, a, -1); tab_gate(hd, 1, b, -1);
        break;
    }
}

// returns outcome | (was_random << 1); rnd supplies the random outcome bit
int tab_measure(void* hd, int q, int rnd) {
    Tab* t = (Tab*)hd;
    int n = t->n;
    int p = -1;
    for (int i = n; i < 2 * n; ++i)
        if (get_bit(row_x(t, i), q)) { p = i; break; }
    if (p >= 0) {
        for (int i = 0; i < 2 * n; ++i)
            if (i != p && get_bit(row_x(t, i), q)) rowsum(t, i, p);
        memcpy(row_x(t, p - n), row_x(t, p), t->W * sizeof(uint64_t));
        memcpy(row_z(t, p - n), row_z(t, p), t->W * sizeof(uint64_t));
        t->r[p - n] = t->r[p];
        memset(row_x(t, p), 0, t->W * sizeof(uint64_t));
        memset(row_z(t, p), 0, t->W * sizeof(uint64_t));
        set_bit(row_z(t, p), q, 1);
        t->r[p] = (uint8_t)(rnd & 1);
        return (rnd & 1) | 2;
    }
    // deterministic: accumulate destabilizer products into scratch row 2n
    int sc = 2 * n;
    memset(row_x(t, sc), 0, t->W * sizeof(uint64_t));
    memset(row_z(t, sc), 0, t->W * sizeof(uint64_t));
    t->r[sc] = 0;
    for (int i = 0; i < n; ++i)
        if (get_bit(row_x(t, i), q)) rowsum(t, sc, i + n);
    return t->r[sc];
}

// expectation of a Pauli string given packed x/z planes (W words each);
// returns +1/-1/0
int tab_expect(void* hd, const uint64_t* px, const uint64_t* pz) {
    Tab* t = (Tab*)hd;
    int n = t->n, W = t->W;
    // commutation with stabilizers
    for (int i = n; i < 2 * n; ++i) {
        long anti = 0;
        const uint64_t* xi = row_x(t, i);
        const uint64_t* zi = row_z(t, i);
        for (int w = 0; w < W; ++w)
            anti += __builtin_popcountll((xi[w] & pz[w]) ^ (zi[w] & px[w]));
        if (anti & 1) return 0;
    }
    int sc = 2 * n;
    memset(row_x(t, sc), 0, W * sizeof(uint64_t));
    memset(row_z(t, sc), 0, W * sizeof(uint64_t));
    t->r[sc] = 0;
    for (int i = 0; i < n; ++i) {
        long anti = 0;
        const uint64_t* xi = row_x(t, i);
        const uint64_t* zi = row_z(t, i);
        for (int w = 0; w < W; ++w)
            anti += __builtin_popcountll((xi[w] & pz[w]) ^ (zi[w] & px[w]));
        if (anti & 1) rowsum(t, sc, i + n);
    }
    for (int w = 0; w < W; ++w)
        if (row_x(t, sc)[w] != px[w] || row_z(t, sc)[w] != pz[w]) return 0;
    return t->r[sc] ? -1 : 1;
}

// measure all qubits per shot on a fresh copy; out[shot*n + q] in {0,1}
void tab_sample(void* hd, int shots, uint64_t seed, uint8_t* out) {
    Tab* t = (Tab*)hd;
    int n = t->n;
    uint64_t s = seed ? seed : 0x9E3779B97F4A7C15ull;
    size_t rows = (size_t)(2 * n + 1);
    uint64_t* xs = (uint64_t*)malloc(rows * t->W * sizeof(uint64_t));
    uint64_t* zs = (uint64_t*)malloc(rows * t->W * sizeof(uint64_t));
    uint8_t* rs = (uint8_t*)malloc(rows);
    memcpy(xs, t->x, rows * t->W * sizeof(uint64_t));
    memcpy(zs, t->z, rows * t->W * sizeof(uint64_t));
    memcpy(rs, t->r, rows);
    for (int k = 0; k < shots; ++k) {
        memcpy(t->x, xs, rows * t->W * sizeof(uint64_t));
        memcpy(t->z, zs, rows * t->W * sizeof(uint64_t));
        memcpy(t->r, rs, rows);
        for (int q = 0; q < n; ++q) {
            int rb = (int)(xorshift64(s) >> 33) & 1;
            out[(size_t)k * n + q] = (uint8_t)(tab_measure(hd, q, rb) & 1);
        }
    }
    memcpy(t->x, xs, rows * t->W * sizeof(uint64_t));
    memcpy(t->z, zs, rows * t->W * sizeof(uint64_t));
    memcpy(t->r, rs, rows);
    free(xs); free(zs); free(rs);
}

// GF(2) rank of the stabilizer block restricted to `region` (X|Z columns)
int tab_entropy_rank(void* hd, const int* region, int k) {
    Tab* t = (Tab*)hd;
    int n = t->n;
    int cols = 2 * k;
    int cw = (cols + 63) / 64;
    uint64_t* m = (uint64_t*)calloc((size_t)n * cw, sizeof(uint64_t));
    for (int i = 0; i < n; ++i) {
        for (int j = 0; j < k; ++j) {
            int q = region[j];
            if (get_bit(row_x(t, n + i), q)) m[(size_t)i * cw + (j >> 6)] |= 1ull << (j & 63);
            int c2 = k + j;
            if (get_bit(row_z(t, n + i), q)) m[(size_t)i * cw + (c2 >> 6)] |= 1ull << (c2 & 63);
        }
    }
    int rank = 0;
    for (int c = 0; c < cols && rank < n; ++c) {
        int piv = -1;
        for (int i = rank; i < n; ++i)
            if ((m[(size_t)i * cw + (c >> 6)] >> (c & 63)) & 1) { piv = i; break; }
        if (piv < 0) continue;
        for (int w = 0; w < cw; ++w) {
            uint64_t tmp = m[(size_t)rank * cw + w];
            m[(size_t)rank * cw + w] = m[(size_t)piv * cw + w];
            m[(size_t)piv * cw + w] = tmp;
        }
        for (int i = 0; i < n; ++i) {
            if (i != rank && ((m[(size_t)i * cw + (c >> 6)] >> (c & 63)) & 1))
                for (int w = 0; w < cw; ++w) m[(size_t)i * cw + w] ^= m[(size_t)rank * cw + w];
        }
        ++rank;
    }
    free(m);
    return rank;
}

// export unpacked planes: x/z are (2n, n) uint8 row-major, r is (2n,)
void tab_get(void* hd, uint8_t* x, uint8_t* z, uint8_t* r) {
    Tab* t = (Tab*)hd;
    int n = t->n;
    for (int i = 0; i < 2 * n; ++i) {
        for (int q = 0; q < n; ++q) {
            x[(size_t)i * n + q] = (uint8_t)get_bit(row_x(t, i), q);
            z[(size_t)i * n + q] = (uint8_t)get_bit(row_z(t, i), q);
        }
        r[i] = t->r[i];
    }
}

void tab_set(void* hd, const uint8_t* x, const uint8_t* z, const uint8_t* r) {
    Tab* t = (Tab*)hd;
    int n = t->n;
    for (int i = 0; i < 2 * n; ++i) {
        for (int q = 0; q < n; ++q) {
            set_bit(row_x(t, i), q, x[(size_t)i * n + q]);
            set_bit(row_z(t, i), q, z[(size_t)i * n + q]);
        }
        t->r[i] = r[i];
    }
}

int tab_nqubits(void* hd) { return ((Tab*)hd)->n; }

// 1 if a Z measurement on q would be random (some stabilizer has X on q)
int tab_is_random(void* hd, int q) {
    Tab* t = (Tab*)hd;
    for (int i = t->n; i < 2 * t->n; ++i)
        if (get_bit(row_x(t, i), q)) return 1;
    return 0;
}

} // extern "C"
