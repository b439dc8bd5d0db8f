// G2 instances of the curve kernels (field Fq2); see curve_kernels.inc.
#define UG_F ug::Fq2
#define UG_DRAIN_F ug::Fq2Call
#define UG_CHAIN_F ug::Fq2Call
#define UG_TEAM_STEP 1
#define UG_NAME(x) UG_SYM(g2_##x)
#include "curve_kernels.inc"
