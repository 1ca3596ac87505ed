// The temperature pore's constants as K8 and K13 take them, and its
// recapture (ops/oob.py pore_recapture), shared by K8 (after the wall
// cases, pore_walls.cu) and K13 (after the pair collisions, post_pairs.cu);
// its radial checks are also the specular pore's nudge's (K14,
// specular_walls.cu).
//
// Every constant is a float32 rounded once on the host from the plain
// version's double (ops/pore_pass.py PoreParams, in the order of enum Param
// below and of PARAM_NAMES there).
#pragma once

namespace amc {
namespace pore {

enum Param {
  kDt, kROa, kCrOa, kCrOaRr, kH, kPlaneCold, kPlaneHot, kRcSq, kECold,
  kEHot, kAlphaCoat, kAlphaGap, kMass, kHalfMass, kGapHiMAr, kGapLoPAr,
  kCrGap, kCrGapSq, kCrGapRr, kCrPore, kCrPoreSq, kCrPoreRr, kCosCone,
  kOneMCos, kTwoPi, kTableZLo, kTableSpan, kZInset, kHMZInset, kROaSq, kOah,
  kHMOah, kGapRSq, kGapBottom, kGapTop, kNumParams
};

// The radial checks of the recapture and of the specular pore's nudge
// (ops/oob.py _radial), after their z checks, in the reference's order: a
// particle outside the open air's radius, then outside the gap's within
// the pore, then outside the coated radius within the coated bands, snaps
// to the axis.  Each radius is compared squared with the host's float32
// of its double square.  Moves (x, y) in place and returns how many of
// the three checks it took.  Shared by K8, K13 and K14.
__device__ __forceinline__ int radial(float& x, float& y, float z,
                                      float r_oa_sq, float oah,
                                      float h_m_oah, float gap_r_sq,
                                      float rc_sq, float gap_bottom,
                                      float gap_top) {
  int taken = 0;
  if (x * x + y * y > r_oa_sq) {
    x = 0.0f;
    y = 0.0f;
    taken += 1;
  }
  bool inside = z > oah && z < h_m_oah;
  if (x * x + y * y > gap_r_sq && inside) {
    x = 0.0f;
    y = 0.0f;
    taken += 1;
  }
  bool in_coated = (z > oah && z < gap_bottom) || (z > gap_top && z < h_m_oah);
  if (x * x + y * y > rc_sq && in_coated) {
    x = 0.0f;
    y = 0.0f;
    taken += 1;
  }
  return taken;
}

// The recapture of one particle: z first, then the three radial checks on
// the updated z (reference order), in the plain version's float32
// operations.  Moves (x, y, z) in place and returns how many of the five
// conditions it took, as pore_recapture counts them.
__device__ __forceinline__ int recapture(const float* c, float& x, float& y,
                                         float& z) {
  int taken = 0;
  if (z < 0.0f) {
    z = c[kZInset];
    taken += 1;
  }
  if (z > c[kH]) {
    z = c[kHMZInset];
    taken += 1;
  }
  return taken + radial(x, y, z, c[kROaSq], c[kOah], c[kHMOah], c[kGapRSq],
                        c[kRcSq], c[kGapBottom], c[kGapTop]);
}

}  // namespace pore
}  // namespace amc
