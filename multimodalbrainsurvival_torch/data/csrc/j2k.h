// JPEG 2000 Part-1 codestream decoder of the port's slide reader (j2k.cc),
// compiled into the same library as tiff_codecs.cc.
#pragma once

#include <cstddef>
#include <cstdint>

namespace j2k {

// Error codes; 3 and 4 are tiff_codecs.cc's, the rest this decoder's own
// (data/codecs.py names them all).
enum Code {
  OK = 0,
  E_TRUNCATED = 3,      // the codestream ends early
  E_CORRUPT = 4,        // not a valid codestream
  E_POC = 19,           // progression order change (POC marker)
  E_RGN = 20,           // region of interest (RGN marker)
  E_PPM = 21,           // packed packet headers, main header (PPM marker)
  E_PPT = 22,           // packed packet headers, tile-part header (PPT marker)
  E_MARKER = 23,        // any other marker this decoder does not read
  E_SIGNED = 24,        // signed components
  E_PRECISION = 25,     // component precision other than 8 bits
  E_SUBSAMPLED = 26,    // XRsiz / YRsiz other than 1
  E_COMPONENTS = 27,    // more than 4 components
  E_BYPASS = 28,        // code-block style 0x01: selective arithmetic bypass
  E_RESET = 29,         // 0x02: context reset on each pass
  E_TERMALL = 30,       // 0x04: termination on each pass
  E_VCAUSAL = 31,       // 0x08: vertically causal context
  E_PTERM = 32,         // 0x10: predictable termination
  E_SEGSYM = 33,        // 0x20: segmentation symbols
  E_STYLE_EXT = 34,     // 0x40 / 0x80: Part-2 / high-throughput code-blocks
  E_MCT = 35,           // a component transform other than none or RCT / ICT
};

// The image's width, height and component count (SIZ); 0 or a code.
int info(const uint8_t* data, size_t n, int* width, int* height, int* ncomp);

// Decode a codestream into out (out_h rows of out_w RGB pixels): the
// image's min(width, out_w) x min(height, out_h) corner is written, as
// Pillow's OpenJPEG decode and convert("RGB") give it (one or two
// components replicate the first, a fourth is dropped). ycbcr: the three
// components are Y, Cb, Cr (TIFF compression 33003) and go through
// Pillow's fixed-point YCbCr -> RGB. Returns 0 or a code; on error out
// may hold part of the image.
int decode_rgb(const uint8_t* data, size_t n, bool ycbcr, uint8_t* out, int out_w, int out_h);

}  // namespace j2k
