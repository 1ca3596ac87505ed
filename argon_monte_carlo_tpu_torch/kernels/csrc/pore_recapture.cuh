// The temperature pore's constants as K8 and K13 take them, and its
// recapture (ops/oob.py pore_recapture), shared by K8 (after the wall
// cases, pore_walls.cu) and K13 (after the pair collisions, post_pairs.cu).
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
  if (x * x + y * y > c[kROaSq]) {
    x = 0.0f;
    y = 0.0f;
    taken += 1;
  }
  bool inside = z > c[kOah] && z < c[kHMOah];
  if (x * x + y * y > c[kGapRSq] && inside) {
    x = 0.0f;
    y = 0.0f;
    taken += 1;
  }
  bool in_coated = (z > c[kOah] && z < c[kGapBottom]) ||
                   (z > c[kGapTop] && z < c[kHMOah]);
  if (x * x + y * y > c[kRcSq] && in_coated) {
    x = 0.0f;
    y = 0.0f;
    taken += 1;
  }
  return taken;
}

}  // namespace pore
}  // namespace amc
