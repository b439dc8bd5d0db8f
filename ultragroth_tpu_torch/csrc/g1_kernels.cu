// G1 instances of the curve kernels (field Fq); see curve_kernels.inc.
#define UG_F ug::Fq
#define UG_NAME(x) ug_g1_##x
#include "curve_kernels.inc"
