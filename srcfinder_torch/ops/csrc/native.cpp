// Host runtime of the port: BIL window repacking, 8-connected labelling and
// the TIFF 6.0 LZW codec. Built with the host compiler into a shared library
// and called through ctypes (srcfinder_torch/core/native.py), which releases
// the interpreter lock for the length of every call. The interface is plain C:
// every buffer is a pointer and a length given by the caller, and no function
// allocates memory that outlives its call.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---- BIL window repack ------------------------------------------------------

// Tile of the (columns x bands) transpose done per line: the source tile is
// TILE_B band rows of TILE_C samples, the destination tile TILE_C rows of
// TILE_B floats, both small enough to stay in L1.
constexpr int64_t TILE_C = 8, TILE_B = 64;

// Kept out of line: inlined into the dtype dispatch below, g++ 12 at -O3 ran
// it at half the speed.
template <typename T>
__attribute__((noinline)) void repack(const char* src, int64_t lines, int64_t s_l,
                                      int64_t s_b, int64_t s_c, int64_t b0, int64_t b1,
                                      int64_t c0, int64_t c1, float* dst) {
  const int64_t nb = b1 - b0, nc = c1 - c0;
  for (int64_t l = 0; l < lines; ++l) {
    const char* line = src + l * s_l + b0 * s_b + c0 * s_c;
    float* out = dst + l * nc * nb;
    for (int64_t cc = 0; cc < nc; cc += TILE_C) {
      const int64_t ce = cc + TILE_C < nc ? cc + TILE_C : nc;
      for (int64_t bb = 0; bb < nb; bb += TILE_B) {
        const int64_t be = bb + TILE_B < nb ? bb + TILE_B : nb;
        for (int64_t b = bb; b < be; ++b) {
          const char* row = line + b * s_b;
          for (int64_t c = cc; c < ce; ++c) {
            T v;
            std::memcpy(&v, row + c * s_c, sizeof(T));
            out[c * nb + b] = static_cast<float>(v);
          }
        }
      }
    }
  }
}

// ---- 8-connected labels -----------------------------------------------------

int32_t find_root(std::vector<int32_t>& parent, int32_t x) {
  while (parent[x] != x) {
    parent[x] = parent[parent[x]];  // path halving
    x = parent[x];
  }
  return x;
}

// Joins the sets of a and b under the smaller root and returns it.
int32_t join(std::vector<int32_t>& parent, int32_t a, int32_t b) {
  a = find_root(parent, a);
  b = find_root(parent, b);
  if (a < b) {
    parent[b] = a;
    return a;
  }
  parent[a] = b;
  return b;
}

// ---- TIFF 6.0 LZW -----------------------------------------------------------
// Codes are written MSB first. 256 is CLEAR, 257 end of information, 258 the
// first string code. The width grows from 9 to 12 bits by libtiff's rule: the
// encoder widens when its next free code reaches 2^bits and sends CLEAR when
// it reaches 4094; the decoder, whose table lags the encoder's by one entry,
// widens when its next free code reaches 2^bits - 1.

constexpr int CLEAR = 256, EOI = 257, FIRST = 258, LAST = 4094, MAX_CODES = 4096;

struct BitWriter {
  uint8_t* out;
  int64_t cap, len = 0;
  uint32_t acc = 0;
  int nacc = 0;
  bool overflow = false;

  void put(uint32_t code, int bits) {
    acc = (acc << bits) | code;
    nacc += bits;
    while (nacc >= 8) {
      nacc -= 8;
      byte(static_cast<uint8_t>(acc >> nacc));
    }
    acc &= (1u << nacc) - 1;
  }
  void flush() {
    if (nacc) byte(static_cast<uint8_t>(acc << (8 - nacc)));
    nacc = 0;
  }
  void byte(uint8_t v) {
    if (len < cap)
      out[len] = v;
    else
      overflow = true;
    ++len;
  }
};

}  // namespace

extern "C" {

// Gathers the window [b0, b1) x [c0, c1) of an (lines, bands, samples) source
// of any byte strides into a contiguous float32 (lines, c1 - c0, b1 - b0).
// dtype: 0 float32, 1 float64, 2 int16, 3 uint16, 4 int32. Returns 0, or -1
// for an unknown dtype.
int srcf_bil_repack(const void* src, int dtype, int64_t lines, int64_t s_l, int64_t s_b,
                    int64_t s_c, int64_t b0, int64_t b1, int64_t c0, int64_t c1, float* dst) {
  const char* s = static_cast<const char*>(src);
  switch (dtype) {
    case 0: repack<float>(s, lines, s_l, s_b, s_c, b0, b1, c0, c1, dst); return 0;
    case 1: repack<double>(s, lines, s_l, s_b, s_c, b0, b1, c0, c1, dst); return 0;
    case 2: repack<int16_t>(s, lines, s_l, s_b, s_c, b0, b1, c0, c1, dst); return 0;
    case 3: repack<uint16_t>(s, lines, s_l, s_b, s_c, b0, b1, c0, c1, dst); return 0;
    case 4: repack<int32_t>(s, lines, s_l, s_b, s_c, b0, b1, c0, c1, dst); return 0;
    default: return -1;
  }
}

// Labels the 8-connected components of a contiguous (h, w) uint8 mask (nonzero
// is foreground) into a contiguous int32 (h, w): 0 for background, components
// numbered from 1 in the raster order of their first pixel. Returns the number
// of components.
int64_t srcf_label8(const uint8_t* mask, int64_t h, int64_t w, int32_t* out) {
  // first pass: a provisional label per pixel from its neighbours above and
  // to the left, their sets joined where two of them meet. The one above
  // touches the other three, so its label alone is enough; else the one up
  // right may need joining with the up-left or left one (which touch).
  std::vector<int32_t> parent;
  for (int64_t r = 0; r < h; ++r) {
    const uint8_t* m = mask + r * w;
    int32_t* lab = out + r * w;
    const int32_t* up = r ? lab - w : nullptr;
    for (int64_t c = 0; c < w; ++c) {
      if (!m[c]) {
        lab[c] = -1;
        continue;
      }
      const int32_t b = up ? up[c] : -1;
      const int32_t a = up && c ? up[c - 1] : -1;
      const int32_t ur = up && c + 1 < w ? up[c + 1] : -1;
      const int32_t d = c ? lab[c - 1] : -1;
      const int32_t side = a >= 0 ? a : d;
      int32_t cur;
      if (b >= 0) {
        cur = b;
      } else if (ur >= 0) {
        cur = side >= 0 ? join(parent, ur, side) : ur;
      } else if (side >= 0) {
        cur = side;
      } else {
        cur = static_cast<int32_t>(parent.size());
        parent.push_back(cur);
      }
      lab[c] = cur;
    }
  }
  // Labels are made in raster order and a join keeps the smaller root, so a
  // parent is always smaller than its child: one pass in order flattens every
  // set onto its root, and the roots in order are the components in the order
  // of their first pixels (which always makes a new label).
  std::vector<int32_t> id(parent.size());
  int32_t count = 0;
  for (size_t i = 0; i < parent.size(); ++i) {
    parent[i] = parent[parent[i]];
    id[i] = parent[i] == static_cast<int32_t>(i) ? ++count : id[parent[i]];
  }
  for (int64_t i = 0; i < h * w; ++i) out[i] = out[i] < 0 ? 0 : id[out[i]];
  return count;
}

// Compresses n bytes into out (cap bytes). Returns the compressed length, or
// -1 if it would exceed cap. A cap of 3 * n / 2 + n / 2000 + 8 always holds.
int64_t srcf_lzw_encode(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
  // child[prefix * 256 + byte] is the code of that string, 0 if none yet;
  // the slots set since the last CLEAR are listed so a CLEAR empties only them
  std::vector<uint16_t> child(static_cast<size_t>(MAX_CODES) * 256, 0);
  std::vector<uint32_t> used;
  used.reserve(LAST - FIRST);
  BitWriter bw{out, cap};
  int bits = 9, next = FIRST;
  bw.put(CLEAR, bits);
  if (n > 0) {
    int prefix = in[0];
    for (int64_t i = 1; i < n; ++i) {
      const uint32_t slot = static_cast<uint32_t>(prefix) * 256 + in[i];
      if (child[slot]) {
        prefix = child[slot];
        continue;
      }
      bw.put(prefix, bits);
      child[slot] = static_cast<uint16_t>(next++);
      used.push_back(slot);
      if (next == LAST) {
        bw.put(CLEAR, bits);
        for (uint32_t u : used) child[u] = 0;
        used.clear();
        bits = 9;
        next = FIRST;
      } else if (next == (1 << bits) && bits < 12) {
        ++bits;
      }
      prefix = in[i];
    }
    bw.put(prefix, bits);
  }
  bw.put(EOI, bits);
  bw.flush();
  return bw.overflow ? -1 : bw.len;
}

// Decompresses n bytes of LZW. Writes at most cap bytes into out and returns
// the whole decoded length, which exceeds cap when out was too small (call
// again with a buffer that large). Decoding stops at EOI or at the end of the
// input. Returns -1 - code for a code that cannot occur in a valid stream.
int64_t srcf_lzw_decode(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
  // the string of code k is the string of prefix[k] followed by tail[k]
  int16_t prefix[MAX_CODES];
  uint8_t tail[MAX_CODES], head[MAX_CODES];
  uint16_t size[MAX_CODES];
  for (int k = 0; k < 256; ++k) {
    prefix[k] = -1;
    tail[k] = head[k] = static_cast<uint8_t>(k);
    size[k] = 1;
  }
  int64_t len = 0, pos = 0;
  uint32_t acc = 0;
  int nacc = 0, bits = 9, next = FIRST, prev = -1;
  auto emit = [&](int code) {
    const int64_t end = len + size[code];
    for (int64_t k = end - 1; k >= len; --k) {
      if (k < cap) out[k] = tail[code];
      code = prefix[code];
    }
    len = end;
  };
  for (;;) {
    while (nacc < bits) {
      if (pos >= n) return len;
      acc = (acc << 8) | in[pos++];
      nacc += 8;
    }
    nacc -= bits;
    const int code = static_cast<int>((acc >> nacc) & ((1u << bits) - 1));
    acc &= (1u << nacc) - 1;
    if (code == EOI) return len;
    if (code == CLEAR) {
      bits = 9;
      next = FIRST;
      prev = -1;
      continue;
    }
    if (prev < 0) {
      if (code > 255) return -1 - code;
    } else if (code <= next && next < MAX_CODES) {
      // a new entry: the previous string and the first byte of this one
      // (of the previous string when the code is the entry being made)
      prefix[next] = static_cast<int16_t>(prev);
      tail[next] = head[code < next ? code : prev];
      head[next] = head[prev];
      size[next] = static_cast<uint16_t>(size[prev] + 1);
      ++next;
    } else if (code >= next) {
      return -1 - code;
    }
    emit(code);
    if (next == (1 << bits) - 1 && bits < 12) ++bits;
    prev = code;
  }
}

}  // extern "C"
