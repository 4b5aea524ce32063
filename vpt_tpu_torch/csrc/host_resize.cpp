// cv2-bit-exact INTER_LINEAR uint8 resize on the host, behind a plain C
// interface (ops/host_resize.py binds it with ctypes, which releases the GIL
// for the call, so a pool of threads resizes frames in parallel).
//
// The algorithm contract is ops/resize.py's (``resize_uint8_exact``, the
// numpy version it is held bit-equal to):
//   * sample mapping f = (float)((dst + 0.5) * (src / dst) - 0.5), the
//     fractional part in float32 and NOT clamped at the borders; only the
//     two gather indices are clamped (border replicate);
//   * weights rounded half-to-even to 11 fractional bits;
//   * horizontal pass row = S[x0]*a0 + S[x1]*a1 in int32;
//   * vertical pass (((b0*(r0>>4))>>16) + ((b1*(r1>>4))>>16) + 2) >> 2, the
//     two products floored separately, as cv2's 8U kernel does.
// It needs nothing but the C++ standard library.

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

void linear_coeffs(int src, int dst, int* sx, int* a0, int* a1) {
    const double scale = (double)src / dst;
    for (int x = 0; x < dst; ++x) {
        float fx = (float)((x + 0.5) * scale - 0.5);
        int s = (int)std::floor(fx);
        fx -= (float)s;
        sx[x] = s;
        a0[x] = (int)std::nearbyintf((1.0f - fx) * 2048.0f);
        a1[x] = (int)std::nearbyintf(fx * 2048.0f);
    }
}

// The coefficient tables of both axes and the two horizontal-pass rows of
// one resize.
struct ResizePlan {
    int sh, sw, ch, dh, dw;
    std::vector<int> sx, ax0, ax1, sy, by0, by1, row0, row1;

    ResizePlan(int sh_, int sw_, int ch_, int dh_, int dw_)
        : sh(sh_), sw(sw_), ch(ch_), dh(dh_), dw(dw_),
          sx(dw_), ax0(dw_), ax1(dw_), sy(dh_), by0(dh_), by1(dh_),
          row0((size_t)dw_ * ch_), row1((size_t)dw_ * ch_) {
        linear_coeffs(sw, dw, sx.data(), ax0.data(), ax1.data());
        linear_coeffs(sh, dh, sy.data(), by0.data(), by1.data());
    }

    static int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

    void hresize(const uint8_t* src, int syi, int* row) const {
        const uint8_t* s = src + (size_t)syi * sw * ch;
        for (int x = 0; x < dw; ++x) {
            const uint8_t* p0 = s + (size_t)clampi(sx[x], sw - 1) * ch;
            const uint8_t* p1 = s + (size_t)clampi(sx[x] + 1, sw - 1) * ch;
            for (int c = 0; c < ch; ++c)
                row[x * ch + c] = p0[c] * ax0[x] + p1[c] * ax1[x];
        }
    }

    void run(const uint8_t* src, uint8_t* dst) {
        int prev0 = -1, prev1 = -1;
        for (int y = 0; y < dh; ++y) {
            const int s0 = clampi(sy[y], sh - 1);
            const int s1 = clampi(sy[y] + 1, sh - 1);
            if (prev0 != s0) { hresize(src, s0, row0.data()); prev0 = s0; }
            if (prev1 != s1) { hresize(src, s1, row1.data()); prev1 = s1; }
            uint8_t* d = dst + (size_t)y * dw * ch;
            const int b0 = by0[y], b1 = by1[y];
            for (int i = 0; i < dw * ch; ++i) {
                int v = ((b0 * (row0[i] >> 4)) >> 16) + (((b1 * (row1[i] >> 4)) >> 16) + 2);
                d[i] = (uint8_t)(v >> 2);
            }
        }
    }
};

}  // namespace

extern "C" {

// src: (sh, sw, ch) uint8, row-major; dst: (dh, dw, ch) uint8.
void vpt_resize_u8(const uint8_t* src, int sh, int sw, int ch, uint8_t* dst, int dh, int dw) {
    ResizePlan(sh, sw, ch, dh, dw).run(src, dst);
}

}  // extern "C"
