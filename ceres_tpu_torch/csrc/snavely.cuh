// The Snavely reprojection residual on jets, shared by K1 (lin.cu) and
// K11's Snavely spec (linearize.cu): the same chain as
// examples/snavely.py SnavelyReprojectionError and rotation.py
// angle_axis_rotate_point, in the same operation order.
#pragma once

#include "jet.cuh"

// Rodrigues rotation with jets, including the small-angle branch of
// rotation.py angle_axis_rotate_point (threshold 1e-6 in f32).
template <int N>
__device__ void aa_rotate(const Jet<N> aa[3], const Jet<N> pt[3],
                          Jet<N> out[3]) {
  typedef Jet<N> J;
  J theta_sq = aa[0] * aa[0] + aa[1] * aa[1] + aa[2] * aa[2];
  const bool small = theta_sq.v < 1e-6f;
  J safe = theta_sq;
  if (small) safe.v = 1.f;
  J theta = jsqrt(safe);
  J sin_t, cos_t;
  jsincos(theta, &sin_t, &cos_t);
  J inv_theta = jconst<N>(1.f) / theta;
  J w[3] = {aa[0] * inv_theta, aa[1] * inv_theta, aa[2] * inv_theta};
  J wxp[3] = {w[1] * pt[2] - w[2] * pt[1], w[2] * pt[0] - w[0] * pt[2],
              w[0] * pt[1] - w[1] * pt[0]};
  J wdp = w[0] * pt[0] + w[1] * pt[1] + w[2] * pt[2];
  J omc = jconst<N>(1.f) - cos_t;
  J axp[3] = {aa[1] * pt[2] - aa[2] * pt[1], aa[2] * pt[0] - aa[0] * pt[2],
              aa[0] * pt[1] - aa[1] * pt[0]};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    J large = pt[i] * cos_t + wxp[i] * sin_t + (w[i] * wdp) * omc;
    J sres = pt[i] + axp[i];
    out[i] = small ? sres : large;
  }
}

// r = focal * distortion(r2) * (-p_xy / p_z) - (obsx, obsy) for the
// camera jets cp [angle_axis 3, translation 3, f, k1, k2] and the point
// jets pt [3]. An inactive lane (valid false) divides by 1, so its values
// stay finite and a mask can zero them (NaN * 0 would survive the mask).
template <int N>
__device__ void snavely_residual(const Jet<N> cp[9], const Jet<N> pt[3],
                                 bool valid, float obsx, float obsy,
                                 Jet<N> r[2]) {
  typedef Jet<N> J;
  J p[3];
  aa_rotate<N>(cp, pt, p);
#pragma unroll
  for (int i = 0; i < 3; ++i) p[i] = p[i] + cp[3 + i];
  J z = valid ? p[2] : jconst<N>(1.f);
  J xp = -(p[0] / z);
  J yp = -(p[1] / z);
  J r2 = xp * xp + yp * yp;
  J dist = jshift(r2 * (cp[7] + cp[8] * r2), 1.f);
  J fd = cp[6] * dist;
  r[0] = jshift(fd * xp, -obsx);
  r[1] = jshift(fd * yp, -obsy);
}
