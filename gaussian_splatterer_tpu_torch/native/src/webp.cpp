// WebP's bit-serial decoders, the C++ half of io/webp.py (which reads the
// RIFF container): the VP8 key-frame decoder of RFC 6386 with libwebp's
// output stage (its "fancy" chroma upsampler and 14-bit YUV -> RGB), the
// VP8L decoder of RFC 9649, and the ALPH chunk's planes (raw or VP8L-coded,
// then unfiltered row by row).  Each routine bounds-checks its input and
// returns a status (kWebp* below; io/webp.py names them); none reads or
// writes past a buffer.  Plain C ABI for ctypes; the caller owns every
// buffer.
//
// There is deliberately no Python twin: the plain reference is Pillow's
// decode (libwebp), which these routines equal byte for byte.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <new>
#include <utility>
#include <vector>

namespace {

enum WebpStatus {
    kWebpOk = 0,
    kWebpVp8Header = 1,      // not a shown key frame, bad start code, zero size
    kWebpVp8Partitions = 2,  // partition 0 or the token partitions past the data
    kWebpVp8Truncated = 3,   // a partition ends before the last macroblock
    kWebpVp8lHeader = 4,     // bad signature or version
    kWebpVp8lTransform = 5,  // a transform twice
    kWebpVp8lCode = 6,       // a prefix code that is not complete, or a bad length code
    kWebpVp8lCache = 7,      // colour cache of more than 11 bits
    kWebpVp8lData = 8,       // a backward reference before the first pixel or past the last
    kWebpVp8lTruncated = 9,  // the stream ends before the image
    kWebpAlphaHeader = 10,   // reserved bits, or an unknown method or pre-processing
    kWebpAlphaTruncated = 11,  // raw alpha shorter than the plane
    kWebpSize = 12,          // the stream's size is not the size the container gave
    kWebpMemory = 13,
};

// The constant tables of RFC 6386 (the coefficient probabilities and
// their update probabilities, the 4x4 intra modes' probabilities in
// libwebp's mode order, the DC and AC dequantisation tables).
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    {
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255}, {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255}, {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255}, {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
    {
        {{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255}, {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
        {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
    {
        {{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255}, {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255}, {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
        {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
    {
        {{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255}, {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255}, {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
};

const uint8_t kCoeffsProba0[4][8][3][11] = {
    {
        {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128}, {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128}, {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
        {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128}, {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128}, {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
        {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128}, {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128}, {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
        {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128}, {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128}, {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
        {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128}, {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128}, {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
        {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128}, {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128}, {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
        {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    },
    {
        {{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62}, {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1}, {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
        {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128}, {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128}, {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
        {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128}, {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128}, {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
        {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128}, {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128}, {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
        {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128}, {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128}, {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
        {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128}, {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128}, {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
        {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128}, {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128}, {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
        {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128}, {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128}, {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}},
    },
    {
        {{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128}, {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128}, {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
        {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128}, {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128}, {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
        {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128}, {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128}, {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
        {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128}, {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128}, {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
        {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128}, {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128}, {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128}, {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128}, {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    },
    {
        {{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255}, {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128}, {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
        {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128}, {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128}, {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
        {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128}, {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128}, {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
        {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128}, {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128}, {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
        {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128}, {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128}, {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
        {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128}, {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128}, {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
        {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128}, {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128}, {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
        {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    },
};

const uint8_t kBModesProba[10][10][9] = {
    {{231, 120, 48, 89, 115, 113, 120, 152, 112},
     {152, 179, 64, 126, 170, 118, 46, 70, 95},
     {175, 69, 143, 80, 85, 82, 72, 155, 103},
     {56, 58, 10, 171, 218, 189, 17, 13, 152},
     {114, 26, 17, 163, 44, 195, 21, 10, 173},
     {121, 24, 80, 195, 26, 62, 44, 64, 85},
     {144, 71, 10, 38, 171, 213, 144, 34, 26},
     {170, 46, 55, 19, 136, 160, 33, 206, 71},
     {63, 20, 8, 114, 114, 208, 12, 9, 226},
     {81, 40, 11, 96, 182, 84, 29, 16, 36}},
    {{134, 183, 89, 137, 98, 101, 106, 165, 148},
     {72, 187, 100, 130, 157, 111, 32, 75, 80},
     {66, 102, 167, 99, 74, 62, 40, 234, 128},
     {41, 53, 9, 178, 241, 141, 26, 8, 107},
     {74, 43, 26, 146, 73, 166, 49, 23, 157},
     {65, 38, 105, 160, 51, 52, 31, 115, 128},
     {104, 79, 12, 27, 217, 255, 87, 17, 7},
     {87, 68, 71, 44, 114, 51, 15, 186, 23},
     {47, 41, 14, 110, 182, 183, 21, 17, 194},
     {66, 45, 25, 102, 197, 189, 23, 18, 22}},
    {{88, 88, 147, 150, 42, 46, 45, 196, 205},
     {43, 97, 183, 117, 85, 38, 35, 179, 61},
     {39, 53, 200, 87, 26, 21, 43, 232, 171},
     {56, 34, 51, 104, 114, 102, 29, 93, 77},
     {39, 28, 85, 171, 58, 165, 90, 98, 64},
     {34, 22, 116, 206, 23, 34, 43, 166, 73},
     {107, 54, 32, 26, 51, 1, 81, 43, 31},
     {68, 25, 106, 22, 64, 171, 36, 225, 114},
     {34, 19, 21, 102, 132, 188, 16, 76, 124},
     {62, 18, 78, 95, 85, 57, 50, 48, 51}},
    {{193, 101, 35, 159, 215, 111, 89, 46, 111},
     {60, 148, 31, 172, 219, 228, 21, 18, 111},
     {112, 113, 77, 85, 179, 255, 38, 120, 114},
     {40, 42, 1, 196, 245, 209, 10, 25, 109},
     {88, 43, 29, 140, 166, 213, 37, 43, 154},
     {61, 63, 30, 155, 67, 45, 68, 1, 209},
     {100, 80, 8, 43, 154, 1, 51, 26, 71},
     {142, 78, 78, 16, 255, 128, 34, 197, 171},
     {41, 40, 5, 102, 211, 183, 4, 1, 221},
     {51, 50, 17, 168, 209, 192, 23, 25, 82}},
    {{138, 31, 36, 171, 27, 166, 38, 44, 229},
     {67, 87, 58, 169, 82, 115, 26, 59, 179},
     {63, 59, 90, 180, 59, 166, 93, 73, 154},
     {40, 40, 21, 116, 143, 209, 34, 39, 175},
     {47, 15, 16, 183, 34, 223, 49, 45, 183},
     {46, 17, 33, 183, 6, 98, 15, 32, 183},
     {57, 46, 22, 24, 128, 1, 54, 17, 37},
     {65, 32, 73, 115, 28, 128, 23, 128, 205},
     {40, 3, 9, 115, 51, 192, 18, 6, 223},
     {87, 37, 9, 115, 59, 77, 64, 21, 47}},
    {{104, 55, 44, 218, 9, 54, 53, 130, 226},
     {64, 90, 70, 205, 40, 41, 23, 26, 57},
     {54, 57, 112, 184, 5, 41, 38, 166, 213},
     {30, 34, 26, 133, 152, 116, 10, 32, 134},
     {39, 19, 53, 221, 26, 114, 32, 73, 255},
     {31, 9, 65, 234, 2, 15, 1, 118, 73},
     {75, 32, 12, 51, 192, 255, 160, 43, 51},
     {88, 31, 35, 67, 102, 85, 55, 186, 85},
     {56, 21, 23, 111, 59, 205, 45, 37, 192},
     {55, 38, 70, 124, 73, 102, 1, 34, 98}},
    {{125, 98, 42, 88, 104, 85, 117, 175, 82},
     {95, 84, 53, 89, 128, 100, 113, 101, 45},
     {75, 79, 123, 47, 51, 128, 81, 171, 1},
     {57, 17, 5, 71, 102, 57, 53, 41, 49},
     {38, 33, 13, 121, 57, 73, 26, 1, 85},
     {41, 10, 67, 138, 77, 110, 90, 47, 114},
     {115, 21, 2, 10, 102, 255, 166, 23, 6},
     {101, 29, 16, 10, 85, 128, 101, 196, 26},
     {57, 18, 10, 102, 102, 213, 34, 20, 43},
     {117, 20, 15, 36, 163, 128, 68, 1, 26}},
    {{102, 61, 71, 37, 34, 53, 31, 243, 192},
     {69, 60, 71, 38, 73, 119, 28, 222, 37},
     {68, 45, 128, 34, 1, 47, 11, 245, 171},
     {62, 17, 19, 70, 146, 85, 55, 62, 70},
     {37, 43, 37, 154, 100, 163, 85, 160, 1},
     {63, 9, 92, 136, 28, 64, 32, 201, 85},
     {75, 15, 9, 9, 64, 255, 184, 119, 16},
     {86, 6, 28, 5, 64, 255, 25, 248, 1},
     {56, 8, 17, 132, 137, 255, 55, 116, 128},
     {58, 15, 20, 82, 135, 57, 26, 121, 40}},
    {{164, 50, 31, 137, 154, 133, 25, 35, 218},
     {51, 103, 44, 131, 131, 123, 31, 6, 158},
     {86, 40, 64, 135, 148, 224, 45, 183, 128},
     {22, 26, 17, 131, 240, 154, 14, 1, 209},
     {45, 16, 21, 91, 64, 222, 7, 1, 197},
     {56, 21, 39, 155, 60, 138, 23, 102, 213},
     {83, 12, 13, 54, 192, 255, 68, 47, 28},
     {85, 26, 85, 85, 128, 128, 32, 146, 171},
     {18, 11, 7, 63, 144, 171, 4, 4, 246},
     {35, 27, 10, 146, 174, 171, 12, 26, 128}},
    {{190, 80, 35, 99, 180, 80, 126, 54, 45},
     {85, 126, 47, 87, 176, 51, 41, 20, 32},
     {101, 75, 128, 139, 118, 146, 116, 128, 85},
     {56, 41, 15, 176, 236, 85, 37, 9, 62},
     {71, 30, 17, 119, 118, 255, 17, 18, 138},
     {101, 38, 60, 138, 55, 70, 43, 26, 142},
     {146, 36, 19, 30, 171, 255, 97, 27, 20},
     {138, 45, 61, 62, 219, 1, 81, 188, 64},
     {32, 41, 20, 117, 151, 142, 20, 21, 163},
     {112, 19, 12, 61, 195, 128, 48, 4, 24}},
};

const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

// VP8L's 120 short distance codes: (dy << 4) | (8 - dx)
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57, 21, 27, 54, 58,
    37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69, 75, 52, 60, 3,
    87, 89, 19, 29, 86, 90, 35, 45, 68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119, 121, 83, 93, 17, 31,
    100, 108, 66, 78, 118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94, 0, 116, 124, 65,
    79, 16, 32, 98, 110, 48, 115, 125, 81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

// ---------------------------------------------------------------------------
// VP8 (RFC 6386), key frames only.

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// intra modes, in libwebp's order (kBModesProba is indexed by these)
enum { B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU,
       DC_NOTOP = 10, DC_NOLEFT, DC_NOTOPLEFT };
const int8_t kYModesIntra4[18] = {-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5,
                                  -B_RD, -B_VR, -B_LD, 7, -B_VL, 8, -B_HD, -B_HU};

// The boolean decoder, in libwebp's form: ``range`` holds the range minus
// one, bytes come in one at a time as bits run out, and a read past the
// end shifts in zeros once and sets ``eof``.
struct BoolReader {
    const uint8_t* buf = nullptr;
    const uint8_t* end = nullptr;
    uint64_t value = 0;
    int bits = -8;
    uint32_t range = 254;
    bool eof = false;

    void init(const uint8_t* start, size_t size) {
        buf = start;
        end = start + size;
        value = 0;
        bits = -8;
        range = 254;
        eof = false;
        load();
    }
    void load() {
        if (buf < end) {
            bits += 8;
            value = (value << 8) | *buf++;
        } else if (!eof) {
            value <<= 8;
            bits += 8;
            eof = true;
        } else {
            bits = 0;
        }
    }
    int get(int prob) {
        uint32_t r = range;
        if (bits < 0) load();
        const int pos = bits;
        const uint32_t split = (r * static_cast<uint32_t>(prob)) >> 8;
        const uint32_t v = static_cast<uint32_t>(value >> pos);
        const int bit = v > split;
        if (bit) {
            r -= split;
            value -= static_cast<uint64_t>(split + 1) << pos;
        } else {
            r = split + 1;
        }
        int log2 = 0;
        for (uint32_t t = r; t > 1; t >>= 1) ++log2;
        const int shift = 7 ^ log2;
        r <<= shift;
        bits -= shift;
        range = r - 1;
        return bit;
    }
    int value_bits(int n) {
        int v = 0;
        while (n-- > 0) v |= get(0x80) << n;
        return v;
    }
    int signed_value(int n) {
        const int v = value_bits(n);
        return get(0x80) ? -v : v;
    }
};

struct QuantMatrix {
    int y1[2], y2[2], uv[2];
};

struct FilterInfo {
    int limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

struct MbInfo {
    uint8_t nz = 0, nz_dc = 0;
};

struct MbData {
    int16_t coeffs[384];
    uint8_t is_i4x4, uvmode, segment, skip;
    uint8_t imodes[16];
};

constexpr int BPS = 32;  // the reconstruction workspace's stride
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : static_cast<uint8_t>(v); }
inline uint8_t avg3(int a, int b, int c) { return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }

// -- inverse transforms -------------------------------------------------------

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void transform_one(const int16_t* in, uint8_t* dst) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {  // vertical pass
        const int a = in[i] + in[8 + i];
        const int b = in[i] - in[8 + i];
        const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
        const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
        tmp[4 * i + 0] = a + d;
        tmp[4 * i + 1] = b + c;
        tmp[4 * i + 2] = b - c;
        tmp[4 * i + 3] = a - d;
    }
    for (int i = 0; i < 4; ++i) {  // horizontal pass, one output row each
        const int dc = tmp[i] + 4;
        const int a = dc + tmp[8 + i];
        const int b = dc - tmp[8 + i];
        const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]);
        const int d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
        uint8_t* row = dst + i * BPS;
        row[0] = clip8(row[0] + ((a + d) >> 3));
        row[1] = clip8(row[1] + ((b + c) >> 3));
        row[2] = clip8(row[2] + ((b - c) >> 3));
        row[3] = clip8(row[3] + ((a - d) >> 3));
    }
}

void transform_wht(const int16_t* in, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
        const int a0 = in[0 + i] + in[12 + i];
        const int a1 = in[4 + i] + in[8 + i];
        const int a2 = in[4 + i] - in[8 + i];
        const int a3 = in[0 + i] - in[12 + i];
        tmp[0 + i] = a0 + a1;
        tmp[8 + i] = a0 - a1;
        tmp[4 + i] = a3 + a2;
        tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; ++i) {
        const int dc = tmp[0 + i * 4] + 3;
        const int a0 = dc + tmp[3 + i * 4];
        const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
        const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
        const int a3 = dc - tmp[3 + i * 4];
        out[0] = static_cast<int16_t>((a0 + a1) >> 3);
        out[16] = static_cast<int16_t>((a3 + a2) >> 3);
        out[32] = static_cast<int16_t>((a0 - a1) >> 3);
        out[48] = static_cast<int16_t>((a3 - a2) >> 3);
        out += 64;
    }
}

// -- intra predictors (dst at the block's top-left in the workspace) ----------

void true_motion(uint8_t* dst, int size) {
    const uint8_t* top = dst - BPS;
    const int tl = top[-1];
    for (int y = 0; y < size; ++y) {
        const int left = dst[-1];
        for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + left - tl);
        dst += BPS;
    }
}

void fill(uint8_t* dst, int size, int v) {
    for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, v, size);
}

void predict_block(uint8_t* dst, int size, int mode) {
    switch (mode) {
        case B_DC: {
            int dc = size;  // the rounding term: 16 for 16x16, 8 for 8x8
            for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
            fill(dst, size, dc >> (size == 16 ? 5 : 4));
            break;
        }
        case DC_NOTOP: {
            int dc = size >> 1;
            for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
            fill(dst, size, dc >> (size == 16 ? 4 : 3));
            break;
        }
        case DC_NOLEFT: {
            int dc = size >> 1;
            for (int j = 0; j < size; ++j) dc += dst[j - BPS];
            fill(dst, size, dc >> (size == 16 ? 4 : 3));
            break;
        }
        case DC_NOTOPLEFT:
            fill(dst, size, 0x80);
            break;
        case B_TM:
            true_motion(dst, size);
            break;
        case B_VE:
            for (int y = 0; y < size; ++y) std::memcpy(dst + y * BPS, dst - BPS, size);
            break;
        case B_HE:
            for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, dst[y * BPS - 1], size);
            break;
        default:
            break;
    }
}

#define DST(x, y) dst[(x) + (y) * BPS]

void predict4(uint8_t* dst, int mode) {
    const uint8_t* top = dst - BPS;
    const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
    const int E = top[4], F = top[5], G = top[6], H = top[7];
    const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
    switch (mode) {
        case B_DC: {
            int dc = 4;
            for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
            fill(dst, 4, dc >> 3);
            break;
        }
        case B_TM:
            true_motion(dst, 4);
            break;
        case B_VE: {
            const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
            for (int y = 0; y < 4; ++y) std::memcpy(dst + y * BPS, v, 4);
            break;
        }
        case B_HE:
            std::memset(dst, avg3(X, I, J), 4);
            std::memset(dst + BPS, avg3(I, J, K), 4);
            std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
            std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
            break;
        case B_RD:
            DST(0, 3) = avg3(J, K, L);
            DST(1, 3) = DST(0, 2) = avg3(I, J, K);
            DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
            DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
            DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
            DST(3, 1) = DST(2, 0) = avg3(C, B, A);
            DST(3, 0) = avg3(D, C, B);
            break;
        case B_LD:
            DST(0, 0) = avg3(A, B, C);
            DST(1, 0) = DST(0, 1) = avg3(B, C, D);
            DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
            DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
            DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
            DST(3, 2) = DST(2, 3) = avg3(F, G, H);
            DST(3, 3) = avg3(G, H, H);
            break;
        case B_VR:
            DST(0, 0) = DST(1, 2) = avg2(X, A);
            DST(1, 0) = DST(2, 2) = avg2(A, B);
            DST(2, 0) = DST(3, 2) = avg2(B, C);
            DST(3, 0) = avg2(C, D);
            DST(0, 3) = avg3(K, J, I);
            DST(0, 2) = avg3(J, I, X);
            DST(0, 1) = DST(1, 3) = avg3(I, X, A);
            DST(1, 1) = DST(2, 3) = avg3(X, A, B);
            DST(2, 1) = DST(3, 3) = avg3(A, B, C);
            DST(3, 1) = avg3(B, C, D);
            break;
        case B_VL:
            DST(0, 0) = avg2(A, B);
            DST(1, 0) = DST(0, 2) = avg2(B, C);
            DST(2, 0) = DST(1, 2) = avg2(C, D);
            DST(3, 0) = DST(2, 2) = avg2(D, E);
            DST(0, 1) = avg3(A, B, C);
            DST(1, 1) = DST(0, 3) = avg3(B, C, D);
            DST(2, 1) = DST(1, 3) = avg3(C, D, E);
            DST(3, 1) = DST(2, 3) = avg3(D, E, F);
            DST(3, 2) = avg3(E, F, G);
            DST(3, 3) = avg3(F, G, H);
            break;
        case B_HU:
            DST(0, 0) = avg2(I, J);
            DST(2, 0) = DST(0, 1) = avg2(J, K);
            DST(2, 1) = DST(0, 2) = avg2(K, L);
            DST(1, 0) = avg3(I, J, K);
            DST(3, 0) = DST(1, 1) = avg3(J, K, L);
            DST(3, 1) = DST(1, 2) = avg3(K, L, L);
            DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) =
                static_cast<uint8_t>(L);
            break;
        case B_HD:
            DST(0, 0) = DST(2, 1) = avg2(I, X);
            DST(0, 1) = DST(2, 2) = avg2(J, I);
            DST(0, 2) = DST(2, 3) = avg2(K, J);
            DST(0, 3) = avg2(L, K);
            DST(3, 0) = avg3(A, B, C);
            DST(2, 0) = avg3(X, A, B);
            DST(1, 0) = DST(3, 1) = avg3(I, X, A);
            DST(1, 1) = DST(3, 2) = avg3(J, I, X);
            DST(1, 2) = DST(3, 3) = avg3(K, J, I);
            DST(1, 3) = avg3(L, K, J);
            break;
        default:
            break;
    }
}

#undef DST

// -- loop filters (p at the first pixel past the edge) ------------------------

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // [-1020, 1020]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // [-112, 112]

inline void do_filter2(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    const int a3 = (a1 + 1) >> 1;
    p[-2 * step] = clip8(p1 + a3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
    const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
    const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int a1 = (27 * a + 63) >> 7;
    const int a2 = (18 * a + 63) >> 7;
    const int a3 = (9 * a + 63) >> 7;
    p[-3 * step] = clip8(p2 + a3);
    p[-2 * step] = clip8(p1 + a2);
    p[-step] = clip8(p0 + a1);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a2);
    p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
    const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
    const int p0 = p[-step], q0 = p[0];
    const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
    if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
    return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
           std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// ``hstride`` steps across the edge, ``vstride`` along it
void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
    const int thresh2 = 2 * thresh + 1;
    for (int i = 0; i < 16; ++i, p += vstride)
        if (needs_filter(p, hstride, thresh2)) do_filter2(p, hstride);
}

void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_t, bool mb_edge) {
    const int thresh2 = 2 * thresh + 1;
    for (int i = 0; i < size; ++i, p += vstride) {
        if (!needs_filter2(p, hstride, thresh2, ithresh)) continue;
        if (hev(p, hstride, hev_t)) {
            do_filter2(p, hstride);
        } else if (mb_edge) {
            do_filter6(p, hstride);
        } else {
            do_filter4(p, hstride);
        }
    }
}

// -- the decoder --------------------------------------------------------------

struct Vp8Decoder {
    int width = 0, height = 0, mb_w = 0, mb_h = 0;
    BoolReader br;
    BoolReader parts[8];
    int num_parts_m1 = 0;
    // segment header
    bool use_segment = false, update_map = false, absolute_delta = true;
    int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
    uint8_t seg_proba[3] = {255, 255, 255};
    // filter header
    int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
    int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
    int filter_type = 0;
    QuantMatrix dqm[4];
    uint8_t proba[4][8][3][11];
    int use_skip = 0, skip_p = 0;
    FilterInfo fstrengths[4][2];
    // planes
    std::vector<uint8_t> y, u, v;
    int ystride = 0, uvstride = 0;
};

int parse_header(Vp8Decoder& d, const uint8_t* buf, size_t size) {
    if (size < 10) return kWebpVp8Header;
    const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
    const bool key_frame = !(bits & 1);
    const int profile = (bits >> 1) & 7;
    const bool show = (bits >> 4) & 1;
    const uint32_t partition_length = bits >> 5;
    if (!key_frame || profile > 3 || !show || partition_length >= size)
        return kWebpVp8Header;
    if (buf[3] != 0x9d || buf[4] != 0x01 || buf[5] != 0x2a) return kWebpVp8Header;
    d.width = ((buf[7] << 8) | buf[6]) & 0x3fff;   // the scaling bits are ignored
    d.height = ((buf[9] << 8) | buf[8]) & 0x3fff;
    if (d.width == 0 || d.height == 0) return kWebpVp8Header;
    d.mb_w = (d.width + 15) >> 4;
    d.mb_h = (d.height + 15) >> 4;
    buf += 10;
    size -= 10;
    if (partition_length > size) return kWebpVp8Partitions;
    BoolReader& br = d.br;
    br.init(buf, partition_length);
    buf += partition_length;
    size -= partition_length;
    br.get(0x80);  // colour space
    br.get(0x80);  // clamping type (libwebp always clamps)
    // segment header
    d.use_segment = br.get(0x80);
    if (d.use_segment) {
        d.update_map = br.get(0x80);
        if (br.get(0x80)) {  // update data
            d.absolute_delta = br.get(0x80);
            for (int s = 0; s < 4; ++s) d.quantizer[s] = br.get(0x80) ? br.signed_value(7) : 0;
            for (int s = 0; s < 4; ++s)
                d.filter_strength[s] = br.get(0x80) ? br.signed_value(6) : 0;
        }
        if (d.update_map)
            for (int s = 0; s < 3; ++s) d.seg_proba[s] = br.get(0x80) ? br.value_bits(8) : 255;
    } else {
        d.update_map = false;
    }
    if (br.eof) return kWebpVp8Header;
    // filter header
    d.simple = br.get(0x80);
    d.level = br.value_bits(6);
    d.sharpness = br.value_bits(3);
    d.use_lf_delta = br.get(0x80);
    if (d.use_lf_delta && br.get(0x80)) {
        for (int i = 0; i < 4; ++i)
            if (br.get(0x80)) d.ref_lf_delta[i] = br.signed_value(6);
        for (int i = 0; i < 4; ++i)
            if (br.get(0x80)) d.mode_lf_delta[i] = br.signed_value(6);
    }
    d.filter_type = d.level == 0 ? 0 : d.simple ? 1 : 2;
    if (br.eof) return kWebpVp8Header;
    // partitions
    d.num_parts_m1 = (1 << br.value_bits(2)) - 1;
    const size_t last = d.num_parts_m1;
    if (size < 3 * last) return kWebpVp8Partitions;
    const uint8_t* sz = buf;
    const uint8_t* part_start = buf + 3 * last;
    size_t left = size - 3 * last;
    for (size_t p = 0; p < last; ++p, sz += 3) {
        size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
        if (psize > left) psize = left;
        d.parts[p].init(part_start, psize);
        part_start += psize;
        left -= psize;
    }
    d.parts[last].init(part_start, left);
    if (left == 0) return kWebpVp8Partitions;
    // quantisers
    const int base_q0 = br.value_bits(7);
    const int dqy1_dc = br.get(0x80) ? br.signed_value(4) : 0;
    const int dqy2_dc = br.get(0x80) ? br.signed_value(4) : 0;
    const int dqy2_ac = br.get(0x80) ? br.signed_value(4) : 0;
    const int dquv_dc = br.get(0x80) ? br.signed_value(4) : 0;
    const int dquv_ac = br.get(0x80) ? br.signed_value(4) : 0;
    auto clipq = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int i = 0; i < 4; ++i) {
        int q;
        if (d.use_segment) {
            q = d.quantizer[i];
            if (!d.absolute_delta) q += base_q0;
        } else if (i > 0) {
            d.dqm[i] = d.dqm[0];
            continue;
        } else {
            q = base_q0;
        }
        QuantMatrix& m = d.dqm[i];
        m.y1[0] = kDcTable[clipq(q + dqy1_dc, 127)];
        m.y1[1] = kAcTable[clipq(q, 127)];
        m.y2[0] = kDcTable[clipq(q + dqy2_dc, 127)] * 2;
        m.y2[1] = (kAcTable[clipq(q + dqy2_ac, 127)] * 101581) >> 16;  // x * 155 / 100
        if (m.y2[1] < 8) m.y2[1] = 8;
        m.uv[0] = kDcTable[clipq(q + dquv_dc, 117)];
        m.uv[1] = kAcTable[clipq(q + dquv_ac, 127)];
    }
    br.get(0x80);  // refresh_entropy_probs: ignored on a key frame
    for (int t = 0; t < 4; ++t)
        for (int b = 0; b < 8; ++b)
            for (int c = 0; c < 3; ++c)
                for (int p = 0; p < 11; ++p)
                    d.proba[t][b][c][p] = br.get(kCoeffsUpdateProba[t][b][c][p])
                                              ? br.value_bits(8)
                                              : kCoeffsProba0[t][b][c][p];
    d.use_skip = br.get(0x80);
    if (d.use_skip) d.skip_p = br.value_bits(8);
    // filter strengths per segment and per i4x4
    if (d.filter_type > 0) {
        for (int s = 0; s < 4; ++s) {
            int base_level;
            if (d.use_segment) {
                base_level = d.filter_strength[s];
                if (!d.absolute_delta) base_level += d.level;
            } else {
                base_level = d.level;
            }
            for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
                FilterInfo& info = d.fstrengths[s][i4x4];
                int level = base_level;
                if (d.use_lf_delta) {
                    level += d.ref_lf_delta[0];
                    if (i4x4) level += d.mode_lf_delta[0];
                }
                level = level < 0 ? 0 : level > 63 ? 63 : level;
                if (level > 0) {
                    int ilevel = level;
                    if (d.sharpness > 0) {
                        ilevel >>= d.sharpness > 4 ? 2 : 1;
                        if (ilevel > 9 - d.sharpness) ilevel = 9 - d.sharpness;
                    }
                    if (ilevel < 1) ilevel = 1;
                    info.ilevel = ilevel;
                    info.limit = 2 * level + ilevel;
                    info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
                } else {
                    info.limit = 0;
                }
                info.inner = i4x4;
            }
        }
    }
    return kWebpOk;
}

void parse_intra_mode(Vp8Decoder& d, uint8_t* top, uint8_t* left, MbData& block) {
    BoolReader& br = d.br;
    if (d.update_map) {
        block.segment = !br.get(d.seg_proba[0]) ? br.get(d.seg_proba[1])
                                                 : br.get(d.seg_proba[2]) + 2;
    } else {
        block.segment = 0;
    }
    block.skip = d.use_skip ? br.get(d.skip_p) : 0;
    block.is_i4x4 = !br.get(145);
    if (!block.is_i4x4) {
        const int ymode = br.get(156) ? (br.get(128) ? B_TM : B_HE) : (br.get(163) ? B_VE : B_DC);
        block.imodes[0] = ymode;
        std::memset(top, ymode, 4);
        std::memset(left, ymode, 4);
    } else {
        uint8_t* modes = block.imodes;
        for (int y = 0; y < 4; ++y) {
            int ymode = left[y];
            for (int x = 0; x < 4; ++x) {
                const uint8_t* prob = kBModesProba[top[x]][ymode];
                int i = kYModesIntra4[br.get(prob[0])];
                while (i > 0) i = kYModesIntra4[2 * i + br.get(prob[i])];
                ymode = -i;
                top[x] = ymode;
            }
            std::memcpy(modes, top, 4);
            modes += 4;
            left[y] = ymode;
        }
    }
    block.uvmode = !br.get(142) ? B_DC : !br.get(114) ? B_VE : br.get(183) ? B_TM : B_HE;
}

// The coefficients of one 4x4 block from position ``n``; returns the
// position after the last one read (16 at most).
int get_coeffs(BoolReader& br, const uint8_t (*bands)[3][11], int ctx, const int* dq, int n,
               int16_t* out) {
    const uint8_t* p = bands[kBands[n]][ctx];
    for (; n < 16; ++n) {
        if (!br.get(p[0])) return n;  // end of block
        while (!br.get(p[1])) {       // a zero
            p = bands[kBands[++n]][0];
            if (n == 16) return 16;
        }
        const uint8_t (*p_ctx)[11] = bands[kBands[n + 1]];
        int v;
        if (!br.get(p[2])) {
            v = 1;
            p = p_ctx[1];
        } else {
            if (!br.get(p[3])) {
                v = !br.get(p[4]) ? 2 : 3 + br.get(p[5]);
            } else if (!br.get(p[6])) {
                if (!br.get(p[7])) {
                    v = 5 + br.get(159);
                } else {
                    v = 7 + 2 * br.get(165);
                    v += br.get(145);
                }
            } else {
                const int bit1 = br.get(p[8]);
                const int bit0 = br.get(p[9 + bit1]);
                const int cat = 2 * bit1 + bit0;
                v = 0;
                for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get(*tab);
                v += 3 + (8 << cat);
            }
            p = p_ctx[2];
        }
        const int s = br.get(0x80) ? -v : v;
        out[kZigzag[n]] = static_cast<int16_t>(s * dq[n > 0]);
    }
    return 16;
}

// Returns whether every coefficient of the macroblock came out zero.
bool parse_residuals(Vp8Decoder& d, BoolReader& br, MbInfo& mb, MbInfo& left_mb,
                     MbData& block) {
    const QuantMatrix& q = d.dqm[block.segment];
    int16_t* dst = block.coeffs;
    std::memset(dst, 0, sizeof(block.coeffs));
    int first;
    const uint8_t (*ac_proba)[3][11];
    uint32_t non_zero = 0;
    if (!block.is_i4x4) {
        int16_t dc[16] = {0};
        const int ctx = mb.nz_dc + left_mb.nz_dc;
        const int nz = get_coeffs(br, d.proba[1], ctx, q.y2, 0, dc);
        mb.nz_dc = left_mb.nz_dc = nz > 0;
        if (nz > 1) {
            transform_wht(dc, dst);
        } else {
            const int dc0 = (dc[0] + 3) >> 3;
            for (int i = 0; i < 256; i += 16) dst[i] = static_cast<int16_t>(dc0);
        }
        first = 1;
        ac_proba = d.proba[0];
    } else {
        first = 0;
        ac_proba = d.proba[3];
    }
    uint8_t tnz = mb.nz & 0x0f, lnz = left_mb.nz & 0x0f;
    for (int y = 0; y < 4; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 4; ++x) {
            const int ctx = l + (tnz & 1);
            const int nz = get_coeffs(br, ac_proba, ctx, q.y1, first, dst);
            l = nz > first;
            tnz = static_cast<uint8_t>((tnz >> 1) | (l << 7));
            if (nz > 1 || dst[0] != 0) non_zero = 1;
            dst += 16;
        }
        tnz >>= 4;
        lnz = static_cast<uint8_t>((lnz >> 1) | (l << 7));
    }
    uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
        uint32_t t = mb.nz >> (4 + ch), lz = left_mb.nz >> (4 + ch);
        for (int y = 0; y < 2; ++y) {
            int l = lz & 1;
            for (int x = 0; x < 2; ++x) {
                const int ctx = l + (t & 1);
                const int nz = get_coeffs(br, d.proba[2], ctx, q.uv, 0, dst);
                l = nz > 0;
                t = (t >> 1) | (l << 3);
                if (nz > 1 || dst[0] != 0) non_zero = 1;
                dst += 16;
            }
            t >>= 2;
            lz = (lz >> 1) | (l << 5);
        }
        out_t_nz |= (t << 4) << ch;
        out_l_nz |= (lz & 0xf0) << ch;
    }
    mb.nz = static_cast<uint8_t>(out_t_nz);
    left_mb.nz = static_cast<uint8_t>(out_l_nz);
    return !non_zero;
}

// Predicts and adds the residuals of the macroblock at (mb_x, mb_y) in the
// workspace ``ws``, whose borders hold its left and top samples.
void reconstruct(Vp8Decoder& d, int mb_x, int mb_y, const MbData& block, uint8_t* ws,
                 uint8_t* top_y, uint8_t* top_u, uint8_t* top_v) {
    uint8_t* y_dst = ws + Y_OFF;
    uint8_t* u_dst = ws + U_OFF;
    uint8_t* v_dst = ws + V_OFF;
    if (mb_x > 0) {  // the left samples: the previous macroblock's right columns
        for (int j = -1; j < 16; ++j) std::memcpy(y_dst + j * BPS - 4, y_dst + j * BPS + 12, 4);
        for (int j = -1; j < 8; ++j) {
            std::memcpy(u_dst + j * BPS - 4, u_dst + j * BPS + 4, 4);
            std::memcpy(v_dst + j * BPS - 4, v_dst + j * BPS + 4, 4);
        }
    }
    uint8_t* ty = top_y + 16 * mb_x;
    uint8_t* tu = top_u + 8 * mb_x;
    uint8_t* tv = top_v + 8 * mb_x;
    if (mb_y > 0) {
        std::memcpy(y_dst - BPS, ty, 16);
        std::memcpy(u_dst - BPS, tu, 8);
        std::memcpy(v_dst - BPS, tv, 8);
    }
    const int16_t* coeffs = block.coeffs;
    if (block.is_i4x4) {
        uint8_t* top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
            if (mb_x >= d.mb_w - 1) {
                std::memset(top_right, ty[15], 4);
            } else {
                std::memcpy(top_right, ty + 16, 4);
            }
        }
        for (int r = 1; r < 4; ++r) std::memcpy(top_right + 4 * r * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n) {
            uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
            predict4(dst, block.imodes[n]);
            transform_one(coeffs + n * 16, dst);
        }
    } else {
        int mode = block.imodes[0];
        if (mode == B_DC)
            mode = mb_x == 0 ? (mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT)
                             : (mb_y == 0 ? DC_NOTOP : B_DC);
        predict_block(y_dst, 16, mode);
        for (int n = 0; n < 16; ++n)
            transform_one(coeffs + n * 16, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
    }
    int uvmode = block.uvmode;
    if (uvmode == B_DC)
        uvmode = mb_x == 0 ? (mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT)
                           : (mb_y == 0 ? DC_NOTOP : B_DC);
    predict_block(u_dst, 8, uvmode);
    predict_block(v_dst, 8, uvmode);
    for (int n = 0; n < 4; ++n) {
        const int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
        transform_one(coeffs + 256 + n * 16, u_dst + off);
        transform_one(coeffs + 320 + n * 16, v_dst + off);
    }
    if (mb_y < d.mb_h - 1) {  // the top samples of the next row, unfiltered
        std::memcpy(ty, y_dst + 15 * BPS, 16);
        std::memcpy(tu, u_dst + 7 * BPS, 8);
        std::memcpy(tv, v_dst + 7 * BPS, 8);
    }
    // into the planes
    for (int j = 0; j < 16; ++j)
        std::memcpy(&d.y[(mb_y * 16 + j) * d.ystride + mb_x * 16], y_dst + j * BPS, 16);
    for (int j = 0; j < 8; ++j) {
        std::memcpy(&d.u[(mb_y * 8 + j) * d.uvstride + mb_x * 8], u_dst + j * BPS, 8);
        std::memcpy(&d.v[(mb_y * 8 + j) * d.uvstride + mb_x * 8], v_dst + j * BPS, 8);
    }
}

void filter_mb(Vp8Decoder& d, int mb_x, int mb_y, const FilterInfo& f) {
    const int limit = f.limit;
    if (limit == 0) return;
    const int ys = d.ystride, uvs = d.uvstride;
    uint8_t* y_dst = &d.y[mb_y * 16 * ys + mb_x * 16];
    if (d.filter_type == 1) {  // simple: luma only
        if (mb_x > 0) simple_filter(y_dst, 1, ys, limit + 4);
        if (f.inner)
            for (int k = 1; k < 4; ++k) simple_filter(y_dst + 4 * k, 1, ys, limit);
        if (mb_y > 0) simple_filter(y_dst, ys, 1, limit + 4);
        if (f.inner)
            for (int k = 1; k < 4; ++k) simple_filter(y_dst + 4 * k * ys, ys, 1, limit);
        return;
    }
    uint8_t* u_dst = &d.u[mb_y * 8 * uvs + mb_x * 8];
    uint8_t* v_dst = &d.v[mb_y * 8 * uvs + mb_x * 8];
    const int il = f.ilevel, hv = f.hev_thresh;
    if (mb_x > 0) {
        filter_loop(y_dst, 1, ys, 16, limit + 4, il, hv, true);
        filter_loop(u_dst, 1, uvs, 8, limit + 4, il, hv, true);
        filter_loop(v_dst, 1, uvs, 8, limit + 4, il, hv, true);
    }
    if (f.inner) {
        for (int k = 1; k < 4; ++k) filter_loop(y_dst + 4 * k, 1, ys, 16, limit, il, hv, false);
        filter_loop(u_dst + 4, 1, uvs, 8, limit, il, hv, false);
        filter_loop(v_dst + 4, 1, uvs, 8, limit, il, hv, false);
    }
    if (mb_y > 0) {
        filter_loop(y_dst, ys, 1, 16, limit + 4, il, hv, true);
        filter_loop(u_dst, uvs, 1, 8, limit + 4, il, hv, true);
        filter_loop(v_dst, uvs, 1, 8, limit + 4, il, hv, true);
    }
    if (f.inner) {
        for (int k = 1; k < 4; ++k)
            filter_loop(y_dst + 4 * k * ys, ys, 1, 16, limit, il, hv, false);
        filter_loop(u_dst + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
        filter_loop(v_dst + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
    }
}

int decode_frame(Vp8Decoder& d) {
    d.ystride = d.mb_w * 16;
    d.uvstride = d.mb_w * 8;
    d.y.assign(static_cast<size_t>(d.ystride) * d.mb_h * 16, 0);
    d.u.assign(static_cast<size_t>(d.uvstride) * d.mb_h * 8, 0);
    d.v.assign(static_cast<size_t>(d.uvstride) * d.mb_h * 8, 0);
    std::vector<uint8_t> intra_t(4 * d.mb_w, B_DC);
    std::vector<MbInfo> mb_info(d.mb_w);
    std::vector<MbData> mb_data(d.mb_w);
    std::vector<FilterInfo> finfo(static_cast<size_t>(d.mb_w) * d.mb_h);
    std::vector<uint8_t> top_y(16 * d.mb_w), top_u(8 * d.mb_w), top_v(8 * d.mb_w);
    uint8_t ws[YUV_SIZE];
    std::memset(ws, 0, sizeof(ws));
    for (int mb_y = 0; mb_y < d.mb_h; ++mb_y) {
        uint8_t intra_l[4];
        std::memset(intra_l, B_DC, 4);
        for (int mb_x = 0; mb_x < d.mb_w; ++mb_x)
            parse_intra_mode(d, &intra_t[4 * mb_x], intra_l, mb_data[mb_x]);
        if (d.br.eof) return kWebpVp8Truncated;
        BoolReader& token_br = d.parts[mb_y & d.num_parts_m1];
        MbInfo left;
        for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) {
            MbData& block = mb_data[mb_x];
            MbInfo& mb = mb_info[mb_x];
            bool skip = d.use_skip ? block.skip : false;
            if (!skip) {
                skip = parse_residuals(d, token_br, mb, left, block);
            } else {
                left.nz = mb.nz = 0;
                if (!block.is_i4x4) left.nz_dc = mb.nz_dc = 0;
                std::memset(block.coeffs, 0, sizeof(block.coeffs));
            }
            if (d.filter_type > 0) {
                FilterInfo& f = finfo[static_cast<size_t>(mb_y) * d.mb_w + mb_x];
                f = d.fstrengths[block.segment][block.is_i4x4];
                f.inner |= !skip;
            }
            if (token_br.eof) return kWebpVp8Truncated;
        }
        // reconstruct the row: the left border is 129, the top 127 on the first row
        uint8_t* y_dst = ws + Y_OFF;
        uint8_t* u_dst = ws + U_OFF;
        uint8_t* v_dst = ws + V_OFF;
        for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
        for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
        if (mb_y > 0) {
            y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
        } else {
            std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
            std::memset(u_dst - BPS - 1, 127, 8 + 1);
            std::memset(v_dst - BPS - 1, 127, 8 + 1);
        }
        for (int mb_x = 0; mb_x < d.mb_w; ++mb_x)
            reconstruct(d, mb_x, mb_y, mb_data[mb_x], ws, top_y.data(), top_u.data(),
                        top_v.data());
    }
    if (d.filter_type > 0)
        for (int mb_y = 0; mb_y < d.mb_h; ++mb_y)
            for (int mb_x = 0; mb_x < d.mb_w; ++mb_x)
                filter_mb(d, mb_x, mb_y, finfo[static_cast<size_t>(mb_y) * d.mb_w + mb_x]);
    return kWebpOk;
}

// -- output: libwebp's fancy upsampler and 14-bit YUV -> RGB ------------------

inline int mult_hi(int v, int c) { return (v * c) >> 8; }
inline uint8_t clip_yuv(int v) {
    return (v & ~16383) == 0 ? static_cast<uint8_t>(v >> 6) : v < 0 ? 0 : 255;
}

inline void yuv_to_rgba(int y, int u, int v, uint8_t* dst) {
    dst[0] = clip_yuv(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
    dst[1] = clip_yuv(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
    dst[2] = clip_yuv(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
    dst[3] = 255;
}

// One pair of output rows from the chroma rows above (``tu``, ``tv``) and
// below (``cu``, ``cv``) them; ``bot_y`` null for a single row.  Each
// chroma value takes the 9-3-3-1 weights as libwebp builds them: from
// two rounded averages, not in one rounding.
void upsample(const uint8_t* top_y, const uint8_t* bot_y, const uint8_t* tu, const uint8_t* tv,
              const uint8_t* cu, const uint8_t* cv, uint8_t* top_dst, uint8_t* bot_dst,
              int len) {
    const int last_pair = (len - 1) >> 1;
    int tl_u = tu[0], tl_v = tv[0], l_u = cu[0], l_v = cv[0];
    yuv_to_rgba(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
    if (bot_y)
        yuv_to_rgba(bot_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bot_dst);
    for (int x = 1; x <= last_pair; ++x) {
        const int t_u = tu[x], t_v = tv[x], c_u = cu[x], c_v = cv[x];
        const int avg_u = tl_u + t_u + l_u + c_u + 8, avg_v = tl_v + t_v + l_v + c_v + 8;
        const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
        const int d03_u = (avg_u + 2 * (tl_u + c_u)) >> 3,
                  d03_v = (avg_v + 2 * (tl_v + c_v)) >> 3;
        yuv_to_rgba(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1,
                    top_dst + (2 * x - 1) * 4);
        yuv_to_rgba(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, top_dst + 2 * x * 4);
        if (bot_y) {
            yuv_to_rgba(bot_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1,
                        bot_dst + (2 * x - 1) * 4);
            yuv_to_rgba(bot_y[2 * x], (d12_u + c_u) >> 1, (d12_v + c_v) >> 1,
                        bot_dst + 2 * x * 4);
        }
        tl_u = t_u;
        tl_v = t_v;
        l_u = c_u;
        l_v = c_v;
    }
    if (!(len & 1)) {
        yuv_to_rgba(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
                    top_dst + (len - 1) * 4);
        if (bot_y)
            yuv_to_rgba(bot_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2,
                        bot_dst + (len - 1) * 4);
    }
}

void emit_rgba(const Vp8Decoder& d, uint8_t* rgba, int64_t stride) {
    const int w = d.width, h = d.height, ys = d.ystride, uvs = d.uvstride;
    const uint8_t* Y = d.y.data();
    const uint8_t* U = d.u.data();
    const uint8_t* V = d.v.data();
    upsample(Y, nullptr, U, V, U, V, rgba, nullptr, w);  // the first row mirrors its chroma
    int y = 0;
    for (; y + 2 < h; y += 2) {
        const int k = y / 2;
        upsample(Y + (y + 1) * ys, Y + (y + 2) * ys, U + k * uvs, V + k * uvs,
                 U + (k + 1) * uvs, V + (k + 1) * uvs, rgba + (y + 1) * stride,
                 rgba + (y + 2) * stride, w);
    }
    if (!(h & 1)) {  // the last row of an even height mirrors its chroma too
        const int k = (h - 1) / 2;
        upsample(Y + (h - 1) * ys, nullptr, U + k * uvs, V + k * uvs, U + k * uvs, V + k * uvs,
                 rgba + (h - 1) * stride, nullptr, w);
    }
}

// ---------------------------------------------------------------------------
// VP8L (RFC 9649).

const uint8_t kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                          7, 8, 9, 10, 11, 12, 13, 14, 15};
const int kAlphabetSize[5] = {256 + 24, 256, 256, 256, 40};  // green, red, blue, alpha, distance
enum { kPredictor = 0, kCrossColor = 1, kSubtractGreen = 2, kColorIndexing = 3 };

// Bits from the low end of each byte.  Past the data the bits read as
// zeros; the stream has ended once more bits were taken than it holds
// (libwebp's window makes that at least 64).
struct LBitReader {
    const uint8_t* data = nullptr;
    size_t len = 0;
    uint64_t pos = 0;  // in bits
    uint64_t limit = 0;

    void init(const uint8_t* d, size_t n) {
        data = d;
        len = n;
        pos = 0;
        limit = n * 8 < 64 ? 64 : static_cast<uint64_t>(n) * 8;
    }
    bool eos() const { return pos > limit; }
    uint32_t peek(int n) const {  // n <= 24
        const uint64_t byte = pos >> 3;
        uint64_t v = 0;
        if (byte + 8 <= len) {
            std::memcpy(&v, data + byte, 8);  // little-endian hosts
        } else {
            for (uint64_t i = 0; i < 8 && byte + i < len; ++i) v |= uint64_t{data[byte + i]} << (8 * i);
        }
        return static_cast<uint32_t>(v >> (pos & 7)) & ((1u << n) - 1);
    }
    uint32_t read(int n) {
        if (eos()) return 0;
        const uint32_t v = peek(n);
        pos += n;
        return v;
    }
};

// A canonical prefix code: a root table on the next ``root_bits`` bits
// (entry: length << 16 | symbol, length 0 marking a longer code) and the
// counts and sorted symbols for codes longer than that.
struct PrefixCode {
    int single = -1;  // the symbol of a one-symbol code, which takes no bits
    int root_bits = 0;
    std::vector<uint32_t> root;
    uint16_t count[16] = {0};
    std::vector<uint16_t> sorted;

    // Builds from the code lengths; false unless the code is complete (or
    // has one symbol).
    bool build(const int* lengths, int n) {
        int total = 0, max_len = 0;
        std::memset(count, 0, sizeof(count));
        for (int s = 0; s < n; ++s) {
            if (lengths[s] > 15) return false;
            if (lengths[s]) {
                ++count[lengths[s]];
                ++total;
                if (lengths[s] > max_len) max_len = lengths[s];
            }
        }
        if (total == 0) return false;
        sorted.clear();
        if (total == 1) {
            for (int s = 0; s < n; ++s)
                if (lengths[s]) single = s;
            return true;
        }
        int64_t kraft = 0;
        for (int l = 1; l <= 15; ++l) kraft += int64_t{count[l]} << (15 - l);
        if (kraft != (1 << 15)) return false;
        int offs[16], next_code[16];
        offs[1] = 0;
        for (int l = 1; l < 15; ++l) offs[l + 1] = offs[l] + count[l];
        sorted.assign(total, 0);
        int code = 0;  // the first code of each length, as DEFLATE assigns them
        for (int l = 1; l <= 15; ++l) {
            next_code[l] = code;
            code = (code + count[l]) << 1;
        }
        root_bits = max_len < 9 ? max_len : 9;
        root.assign(size_t{1} << root_bits, 0);
        for (int s = 0; s < n; ++s) {
            const int l = lengths[s];
            if (!l) continue;
            sorted[offs[l]++] = static_cast<uint16_t>(s);
            const int c = next_code[l]++;
            if (l > root_bits) continue;
            int rev = 0;
            for (int i = 0; i < l; ++i) rev |= ((c >> i) & 1) << (l - 1 - i);
            for (int j = rev; j < (1 << root_bits); j += 1 << l)
                root[j] = static_cast<uint32_t>(l) << 16 | static_cast<uint32_t>(s);
        }
        return true;
    }

    int read(LBitReader& br) const {
        if (single >= 0) return single;
        const uint32_t window = br.peek(15);
        const uint32_t e = root[window & ((1u << root_bits) - 1)];
        if (e >> 16) {
            br.pos += e >> 16;
            return static_cast<int>(e & 0xffff);
        }
        // a code longer than the root table: walk it one bit at a time
        int code = 0, first = 0, index = 0;
        for (int l = 1; l <= 15; ++l) {
            code |= (window >> (l - 1)) & 1;
            const int c = count[l];
            if (code - first < c) {
                br.pos += l;
                return sorted[index + code - first];
            }
            index += c;
            first = (first + c) << 1;
            code <<= 1;
        }
        br.pos += 15;  // not reached for a complete code
        return 0;
    }
};

// A pixel buffer left uninitialised: a broken stream that claims a huge
// image and ends early touches only the pages it wrote.
struct Pixels {
    std::unique_ptr<uint32_t[]> p;
    size_t n = 0;

    bool reset(size_t k) {
        p.reset(new (std::nothrow) uint32_t[k ? k : 1]);
        n = k;
        return p != nullptr;
    }
    uint32_t& operator[](size_t i) { return p[i]; }
    const uint32_t& operator[](size_t i) const { return p[i]; }
    void swap(Pixels& o) {
        p.swap(o.p);
        std::swap(n, o.n);
    }
};

struct Group {
    PrefixCode codes[5];
};

struct Transform {
    int type = 0, bits = 0, xsize = 0, ysize = 0;
    Pixels data;
};

struct Vp8lDecoder {
    LBitReader br;
    Transform transforms[4];
    int num_transforms = 0;
    unsigned seen = 0;
    int status = kWebpOk;

    bool fail(int s) {
        if (status == kWebpOk) status = br.eos() ? kWebpVp8lTruncated : s;
        return false;
    }
};

inline int sub_sample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

bool read_code(Vp8lDecoder& d, int alphabet, PrefixCode& out) {
    LBitReader& br = d.br;
    std::vector<int> lengths(alphabet, 0);
    if (br.read(1)) {  // simple code: one or two symbols
        const int num = br.read(1) + 1;
        const int first_8bit = br.read(1);
        const int s0 = br.read(first_8bit ? 8 : 1);
        if (s0 < alphabet) lengths[s0] = 1;
        if (num == 2) {
            const int s1 = br.read(8);
            if (s1 < alphabet) lengths[s1] = 1;
        }
    } else {
        int cl_lengths[19] = {0};
        const int num_codes = br.read(4) + 4;
        for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthCodeOrder[i]] = br.read(3);
        PrefixCode cl;
        if (!cl.build(cl_lengths, 19)) return d.fail(kWebpVp8lCode);
        int max_symbol = alphabet;
        if (br.read(1)) {
            const int length_nbits = 2 + 2 * br.read(3);
            max_symbol = 2 + br.read(length_nbits);
            if (max_symbol > alphabet) return d.fail(kWebpVp8lCode);
        }
        int prev = 8, symbol = 0;
        while (symbol < alphabet) {
            if (max_symbol-- == 0) break;
            if (br.eos()) return d.fail(kWebpVp8lTruncated);
            const int len = cl.read(br);
            if (len < 16) {
                lengths[symbol++] = len;
                if (len) prev = len;
            } else {
                const int slot = len - 16;
                static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
                const int repeat = static_cast<int>(br.read(kExtra[slot])) + kOffset[slot];
                if (symbol + repeat > alphabet) return d.fail(kWebpVp8lCode);
                const int v = len == 16 ? prev : 0;
                for (int i = 0; i < repeat; ++i) lengths[symbol++] = v;
            }
        }
    }
    if (br.eos()) return d.fail(kWebpVp8lTruncated);
    if (!out.build(lengths.data(), alphabet)) return d.fail(kWebpVp8lCode);
    return true;
}

inline int copy_distance(int sym, LBitReader& br) {
    if (sym < 4) return sym + 1;
    const int extra = (sym - 2) >> 1;
    const int offset = (2 + (sym & 1)) << extra;
    return offset + static_cast<int>(br.read(extra)) + 1;
}

inline int plane_to_distance(int xsize, int code) {
    if (code > 120) return code - 120;
    const int dc = kCodeToPlane[code - 1];
    const int dist = (dc >> 4) * xsize + 8 - (dc & 0xf);
    return dist >= 1 ? dist : 1;
}


inline uint32_t add_pixels(uint32_t a, uint32_t b) {
    const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
    const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
    return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
    return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline uint32_t clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : static_cast<uint32_t>(v); }

// Per channel: clip(a + b - c), or with ``half`` clip(a + (a - b) / 2).
inline uint32_t clamped(uint32_t a, uint32_t b, uint32_t c, bool half) {
    uint32_t out = 0;
    for (int sh = 0; sh < 32; sh += 8) {
        const int x = (a >> sh) & 0xff, y = (b >> sh) & 0xff, z = (c >> sh) & 0xff;
        out |= clip255(half ? x + (x - y) / 2 : x + y - z) << sh;
    }
    return out;
}

inline uint32_t select_pred(uint32_t t, uint32_t l, uint32_t tl) {
    int diff = 0;  // sum |L - TL| - sum |T - TL| over the channels
    for (int sh = 0; sh < 32; sh += 8) {
        const int a = (t >> sh) & 0xff, b = (l >> sh) & 0xff, c = (tl >> sh) & 0xff;
        diff += std::abs(b - c) - std::abs(a - c);
    }
    return diff <= 0 ? t : l;
}

// The 14 predictors of the predictor transform; modes 14 and 15 read as 0.
inline uint32_t predict(int mode, uint32_t L, uint32_t T, uint32_t TR, uint32_t TL) {
    switch (mode) {
        case 1: return L;
        case 2: return T;
        case 3: return TR;
        case 4: return TL;
        case 5: return average2(average2(L, TR), T);
        case 6: return average2(L, TL);
        case 7: return average2(L, T);
        case 8: return average2(TL, T);
        case 9: return average2(T, TR);
        case 10: return average2(average2(L, TL), average2(T, TR));
        case 11: return select_pred(T, L, TL);
        case 12: return clamped(L, T, TL, false);
        case 13: return clamped(average2(L, T), TL, 0, true);
        default: return 0xff000000u;
    }
}

bool decode_stream(Vp8lDecoder& d, int xsize, int ysize, bool level0, Pixels& out);

bool read_transform(Vp8lDecoder& d, int& xsize, int ysize) {
    LBitReader& br = d.br;
    const int type = br.read(2);
    if (d.seen & (1u << type)) return d.fail(kWebpVp8lTransform);
    d.seen |= 1u << type;
    Transform& t = d.transforms[d.num_transforms++];
    t.type = type;
    t.xsize = xsize;
    t.ysize = ysize;
    if (type == kPredictor || type == kCrossColor) {
        t.bits = br.read(3) + 2;
        return decode_stream(d, sub_sample(xsize, t.bits), sub_sample(ysize, t.bits), false,
                             t.data);
    }
    if (type == kColorIndexing) {
        const int num_colors = br.read(8) + 1;
        t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
        xsize = sub_sample(t.xsize, t.bits);
        Pixels pal;
        if (!decode_stream(d, num_colors, 1, false, pal)) return false;
        const int final_num = 1 << (8 >> t.bits);
        if (!t.data.reset(final_num)) return d.fail(kWebpMemory);
        for (int i = 0; i < final_num; ++i) t.data[i] = 0;  // past the palette: transparent black
        uint32_t prev = 0;
        for (int i = 0; i < num_colors; ++i) {  // each entry is a delta on the one before
            uint32_t c = 0;
            for (int sh = 0; sh < 32; sh += 8)
                c |= (((pal[i] >> sh) + (prev >> sh)) & 0xff) << sh;
            t.data[i] = prev = c;
        }
    }
    return true;
}

bool decode_pixels(Vp8lDecoder& d, int xsize, int ysize, int cache_bits,
                   const std::vector<Group>& groups, const Pixels& meta, int meta_bits,
                   Pixels& out) {
    LBitReader& br = d.br;
    const int64_t total = int64_t{xsize} * ysize;
    if (!out.reset(static_cast<size_t>(total))) return d.fail(kWebpMemory);
    std::vector<uint32_t> cache(cache_bits ? size_t{1} << cache_bits : 0, 0);
    const int meta_xsize = meta_bits ? sub_sample(xsize, meta_bits) : 0;
    const int cache_shift = 32 - cache_bits;
    int64_t pos = 0;
    int col = 0, row = 0;
    auto insert = [&](uint32_t argb) {
        if (cache_bits) cache[(argb * 0x1e35a7bdu) >> cache_shift] = argb;
    };
    while (pos < total) {
        const Group& g = groups[meta_bits ? meta[(row >> meta_bits) * meta_xsize +
                                                 (col >> meta_bits)] : 0];
        const int code = g.codes[0].read(br);
        if (code < 256) {
            const uint32_t r = g.codes[1].read(br), b = g.codes[2].read(br),
                           a = g.codes[3].read(br);
            const uint32_t argb = a << 24 | r << 16 | static_cast<uint32_t>(code) << 8 | b;
            out[pos++] = argb;
            insert(argb);
            if (++col >= xsize) {
                col = 0;
                ++row;
            }
        } else if (code < 256 + 24) {
            const int length = copy_distance(code - 256, br);
            const int dist_sym = g.codes[4].read(br);
            const int dist = plane_to_distance(xsize, copy_distance(dist_sym, br));
            if (br.eos()) return d.fail(kWebpVp8lTruncated);
            if (pos < dist || total - pos < length) return d.fail(kWebpVp8lData);
            for (int i = 0; i < length; ++i, ++pos) {
                out[pos] = out[pos - dist];
                insert(out[pos]);
            }
            col += length;
            while (col >= xsize) {
                col -= xsize;
                ++row;
            }
        } else {
            const int key = code - 256 - 24;
            if (key >= static_cast<int>(cache.size())) return d.fail(kWebpVp8lCode);
            const uint32_t argb = cache[key];
            out[pos++] = argb;
            insert(argb);
            if (++col >= xsize) {
                col = 0;
                ++row;
            }
        }
        if (br.eos()) return d.fail(kWebpVp8lTruncated);
    }
    return true;
}

bool decode_stream(Vp8lDecoder& d, int xsize, int ysize, bool level0, Pixels& out) {
    LBitReader& br = d.br;
    int txsize = xsize;
    const int first_transform = d.num_transforms;
    if (level0)
        while (br.read(1))
            if (!read_transform(d, txsize, ysize)) return false;
    int cache_bits = 0;
    if (br.read(1)) {
        cache_bits = br.read(4);
        if (cache_bits < 1 || cache_bits > 11) return d.fail(kWebpVp8lCache);
    }
    Pixels meta;
    int meta_bits = 0, num_groups = 1, num_used = 1;
    std::vector<int> used;  // a group's index among the groups the image uses, or -1
    if (level0 && br.read(1)) {
        meta_bits = br.read(3) + 2;
        const int mw = sub_sample(txsize, meta_bits), mh = sub_sample(ysize, meta_bits);
        if (!decode_stream(d, mw, mh, false, meta)) return false;
        used.assign(65536, -1);
        num_used = 0;
        for (size_t i = 0; i < meta.n; ++i) {
            const int m = (meta[i] >> 8) & 0xffff;
            if (m + 1 > num_groups) num_groups = m + 1;
            if (used[m] < 0) used[m] = num_used++;
            meta[i] = used[m];
        }
    }
    if (br.eos()) return d.fail(kWebpVp8lTruncated);
    // every group is read and must be valid; only those the image uses are kept
    std::vector<Group> groups(num_used);
    for (int i = 0; i < num_groups; ++i)
        for (int j = 0; j < 5; ++j) {
            const int alphabet = kAlphabetSize[j] + (j == 0 && cache_bits ? 1 << cache_bits : 0);
            const int slot = meta_bits ? used[i] : 0;
            PrefixCode unused;
            if (!read_code(d, alphabet, slot < 0 ? unused : groups[slot].codes[j])) return false;
        }
    if (!decode_pixels(d, txsize, ysize, cache_bits, groups, meta, meta_bits, out)) return false;
    if (!level0) return true;
    // the inverse transforms, last read first
    for (int i = d.num_transforms - 1; i >= first_transform; --i) {
        const Transform& t = d.transforms[i];
        const int w = t.xsize, h = t.ysize;
        if (t.type == kSubtractGreen) {
            for (size_t k = 0; k < out.n; ++k) {
                uint32_t& p = out[k];
                const uint32_t g = (p >> 8) & 0xff;
                const uint32_t rb = ((p & 0x00ff00ffu) + (g << 16 | g)) & 0x00ff00ffu;
                p = (p & 0xff00ff00u) | rb;
            }
        } else if (t.type == kCrossColor) {
            const int tw = sub_sample(w, t.bits);
            for (int y = 0; y < h; ++y)
                for (int x = 0; x < w; ++x) {
                    const uint32_t m = t.data[(y >> t.bits) * tw + (x >> t.bits)];
                    const int8_t g2r = static_cast<int8_t>(m & 0xff);
                    const int8_t g2b = static_cast<int8_t>((m >> 8) & 0xff);
                    const int8_t r2b = static_cast<int8_t>((m >> 16) & 0xff);
                    uint32_t& p = out[static_cast<size_t>(y) * w + x];
                    const int8_t green = static_cast<int8_t>(p >> 8);
                    int red = (p >> 16) & 0xff, blue = p & 0xff;
                    red = (red + ((g2r * green) >> 5)) & 0xff;
                    blue += (g2b * green) >> 5;
                    blue += (r2b * static_cast<int8_t>(red)) >> 5;
                    blue &= 0xff;
                    p = (p & 0xff00ff00u) | static_cast<uint32_t>(red) << 16 |
                        static_cast<uint32_t>(blue);
                }
        } else if (t.type == kPredictor) {
            const int tw = sub_sample(w, t.bits);
            for (int y = 0; y < h; ++y)
                for (int x = 0; x < w; ++x) {
                    uint32_t* p = &out[static_cast<size_t>(y) * w + x];
                    uint32_t pred;
                    if (y == 0) {
                        pred = x == 0 ? 0xff000000u : p[-1];
                    } else if (x == 0) {
                        pred = p[-w];
                    } else {
                        const int mode = (t.data[(y >> t.bits) * tw + (x >> t.bits)] >> 8) & 0xf;
                        pred = predict(mode, p[-1], p[-w], p[-w + 1], p[-w - 1]);
                    }
                    *p = add_pixels(*p, pred);
                }
        } else {  // colour indexing: unpack the bundled indices
            const int bits_per_px = 8 >> t.bits, per_byte_mask = (1 << t.bits) - 1;
            const uint32_t idx_mask = (1u << bits_per_px) - 1;
            const int pw = sub_sample(w, t.bits);
            Pixels full;
            if (!full.reset(static_cast<size_t>(w) * h)) return d.fail(kWebpMemory);
            for (int y = 0; y < h; ++y) {
                const uint32_t* src = &out[static_cast<size_t>(y) * pw];
                uint32_t packed = 0;
                for (int x = 0; x < w; ++x) {
                    if ((x & per_byte_mask) == 0) packed = (*src++ >> 8) & 0xff;
                    full[static_cast<size_t>(y) * w + x] = t.data[packed & idx_mask];
                    packed >>= bits_per_px;
                }
            }
            out.swap(full);
        }
    }
    return true;
}

// ---------------------------------------------------------------------------
// ALPH: undo the filter of each row in place, the row above as reference.

inline uint8_t gradient(int a, int b, int c) {
    const int g = a + b - c;
    return static_cast<uint8_t>((g & ~0xff) == 0 ? g : g < 0 ? 0 : 255);
}

void unfilter_alpha(int filter, uint8_t* plane, int w, int h) {
    for (int y = 0; y < h; ++y) {
        uint8_t* row = plane + static_cast<size_t>(y) * w;
        const uint8_t* prev = y ? row - w : nullptr;
        if (filter == 0) continue;
        if (filter == 1 || !prev) {  // horizontal, and the first row of the others
            uint8_t pred = prev ? prev[0] : 0;
            for (int x = 0; x < w; ++x) pred = row[x] = static_cast<uint8_t>(pred + row[x]);
        } else if (filter == 2) {  // vertical
            for (int x = 0; x < w; ++x) row[x] = static_cast<uint8_t>(prev[x] + row[x]);
        } else {  // gradient
            uint8_t top = prev[0], top_left = top, left = top;
            for (int x = 0; x < w; ++x) {
                top = prev[x];
                left = static_cast<uint8_t>(row[x] + gradient(left, top, top_left));
                top_left = top;
                row[x] = left;
            }
        }
    }
}

int vp8l_argb(const uint8_t* src, int64_t n, int w, int h, bool header, Pixels& px) {
    Vp8lDecoder d;
    d.br.init(src, static_cast<size_t>(n));
    if (header) {
        if (d.br.read(8) != 0x2f) return kWebpVp8lHeader;
        const int ww = d.br.read(14) + 1, hh = d.br.read(14) + 1;
        d.br.read(1);  // alpha_is_used: the container decides (io/webp.py)
        if (d.br.read(3) != 0) return kWebpVp8lHeader;
        if (d.br.eos()) return kWebpVp8lTruncated;
        if (ww != w || hh != h) return kWebpSize;
    }
    if (!decode_stream(d, w, h, true, px)) return d.status ? d.status : kWebpVp8lData;
    return kWebpOk;
}

}  // namespace

extern "C" {

// A VP8 key frame (the payload of a ``VP8 `` chunk, ``n`` bytes) of
// ``w`` x ``h`` -> RGBA rows of ``stride`` bytes at ``rgba``, alpha 255.
int gst_webp_vp8(const uint8_t* src, int64_t n, int w, int h, uint8_t* rgba, int64_t stride) {
    if (n < 0) return kWebpVp8Header;
    try {
        Vp8Decoder d;
        int s = parse_header(d, src, static_cast<size_t>(n));
        if (s != kWebpOk) return s;
        if (d.width != w || d.height != h) return kWebpSize;
        s = decode_frame(d);
        if (s != kWebpOk) return s;
        emit_rgba(d, rgba, stride);
        return kWebpOk;
    } catch (...) {
        return kWebpMemory;
    }
}

// A VP8L image (the payload of a ``VP8L`` chunk) of ``w`` x ``h`` -> RGBA
// rows of ``stride`` bytes at ``rgba``, its own alpha kept.
int gst_webp_vp8l(const uint8_t* src, int64_t n, int w, int h, uint8_t* rgba, int64_t stride) {
    if (n < 0) return kWebpVp8lHeader;
    try {
        Pixels px;
        const int s = vp8l_argb(src, n, w, h, true, px);
        if (s != kWebpOk) return s;
        for (int y = 0; y < h; ++y) {
            uint8_t* out = rgba + y * stride;
            for (int x = 0; x < w; ++x, out += 4) {
                const uint32_t argb = px[static_cast<size_t>(y) * w + x];
                out[0] = (argb >> 16) & 0xff;
                out[1] = (argb >> 8) & 0xff;
                out[2] = argb & 0xff;
                out[3] = argb >> 24;
            }
        }
        return kWebpOk;
    } catch (...) {
        return kWebpMemory;
    }
}

// An ALPH chunk's payload (its header byte, then the plane raw or as a
// VP8L stream without signature and size, alpha in its green channel) ->
// the ``w`` x ``h`` alpha plane at ``alpha``, unfiltered.
int gst_webp_alpha(const uint8_t* src, int64_t n, int w, int h, uint8_t* alpha) {
    if (n <= 1) return kWebpAlphaTruncated;
    const int method = src[0] & 3, filter = (src[0] >> 2) & 3;
    const int pre_processing = (src[0] >> 4) & 3, reserved = src[0] >> 6;
    if (method > 1 || pre_processing > 1 || reserved != 0) return kWebpAlphaHeader;
    const size_t plane = static_cast<size_t>(w) * h;
    if (method == 0) {
        if (static_cast<size_t>(n - 1) < plane) return kWebpAlphaTruncated;
        std::memcpy(alpha, src + 1, plane);
    } else {
        try {
            Pixels px;
            const int s = vp8l_argb(src + 1, n - 1, w, h, false, px);
            if (s != kWebpOk) return s;
            for (size_t i = 0; i < plane; ++i) alpha[i] = (px[i] >> 8) & 0xff;
        } catch (...) {
            return kWebpMemory;
        }
    }
    unfilter_alpha(filter, alpha, w, h);
    return kWebpOk;
}

}  // extern "C"
