"""BN254 (alt_bn128) curve and field constants.

Parity notes (reference: rarimo/ultragroth):
  - Scalar field prime r pinned at src/prover.cpp:73-86.
  - Base field prime q and Montgomery constants at
    build/fq_raw_generic.cpp:5-8 and fr_raw_generic.cpp:5-8.
  - Pairing Frobenius twist constants at src/groth16.cpp:298-312.

All big integers here are plain Python ints; device-side limb encodings are
derived in `ultragroth_tpu_torch.ops.limbs`.
"""

# ---------------------------------------------------------------------------
# Field moduli
# ---------------------------------------------------------------------------

# BN254 scalar field (order of G1/G2; the "Fr" field witness values live in).
FR_MODULUS = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# BN254 base field (coordinates of curve points live in).
FQ_MODULUS = 21888242871839275222246405745257275088696311157297823662689037894645226208583

# Montgomery radix used by the 4x64-bit reference representation.  The wire
# formats (zkey point coordinates, coefficient values) store x*R mod p.
MONT_BITS = 256
MONT_R = 1 << MONT_BITS

FR_R = MONT_R % FR_MODULUS
FR_R2 = (MONT_R * MONT_R) % FR_MODULUS
FR_R_INV = pow(MONT_R, -1, FR_MODULUS)

FQ_R = MONT_R % FQ_MODULUS
FQ_R2 = (MONT_R * MONT_R) % FQ_MODULUS
FQ_R_INV = pow(MONT_R, -1, FQ_MODULUS)

# ---------------------------------------------------------------------------
# Curve parameters:  E/Fq : y^2 = x^3 + 3,  E'/Fq2 : y^2 = x^3 + 3/(9+u)
# ---------------------------------------------------------------------------

CURVE_B = 3
G1_GENERATOR = (1, 2)

# Fq2 = Fq[u] / (u^2 + 1); elements are (c0, c1) = c0 + c1*u.
FQ2_NON_RESIDUE = (9, 1)  # xi = 9 + u, the sextic twist factor

# b' = 3 / (9+u) on the twist (D-type twist).
_xi_norm_inv = pow(9 * 9 + 1, -1, FQ_MODULUS)
G2_B = (
    (3 * 9 * _xi_norm_inv) % FQ_MODULUS,
    (-3 * _xi_norm_inv) % FQ_MODULUS,
)

# Standard BN254 G2 generator (snarkjs / EIP-197 convention).
G2_GENERATOR = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)

# BN curve parameter u ("x" in the literature); 6u+2 drives the ate loop.
# Matches the reference final exponentiation constant
# (src/groth16.cpp:618).
BN_U = 4965661367192848881
ATE_LOOP_COUNT = 6 * BN_U + 2  # 29793968203157093288

# Order of the multiplicative 2-adic subgroup of Fr: r - 1 = 2^28 * odd.
FR_TWO_ADICITY = 28
# Smallest quadratic non-residue of Fr (ffjavascript/ffiasm both derive
# their FFT root tables from it).
FR_NQR = 5
FR_ROOT_OF_UNITY = pow(FR_NQR, (FR_MODULUS - 1) >> FR_TWO_ADICITY, FR_MODULUS)

# ---------------------------------------------------------------------------
# zkey / wtns container constants (iden3 binfile format)
# ---------------------------------------------------------------------------

ZKEY_MAGIC = b"zkey"
WTNS_MAGIC = b"wtns"
GROTH16_PROTOCOL_ID = 1
ULTRAGROTH_PROTOCOL_ID = 1337

# Groth16 zkey section ids (reference: src/zkey_utils.hpp:11-42)
ZKEY_SEC_HEADER = 1
ZKEY_SEC_GROTH_HEADER = 2
ZKEY_SEC_IC = 3
ZKEY_SEC_COEFS = 4
ZKEY_SEC_POINTS_A = 5
ZKEY_SEC_POINTS_B1 = 6
ZKEY_SEC_POINTS_B2 = 7
ZKEY_SEC_POINTS_C = 8
ZKEY_SEC_POINTS_H = 9

# UltraGroth zkey extra sections (protocol id 1337)
UG_SEC_ROUND_POINTS_C = 8
UG_SEC_FINAL_POINTS_C = 9
UG_SEC_ROUND_INDEXES = 10
UG_SEC_FINAL_INDEXES = 11
UG_SEC_POINTS_H = 12

# uwtns extra sections (reference: src/prover.cpp:287-292)
UWTNS_SEC_CHUNKS = 3
UWTNS_SEC_FREQUENCIES = 4
UWTNS_SEC_WTNS_INDEXES = 5
UWTNS_SEC_PUSH_INDEXES = 6

# C-API buffer-protocol constants (reference: src/prover.cpp:55-71)
PROOF_BUFFER_MIN_SIZE = 810
PROOF_BUFFER_MIN_SIZE_ULTRAGROTH = 1400


def public_buffer_min_size(count: int) -> int:
    """Reference: PublicBufferMinSize, src/prover.cpp:67-71."""
    return count * 82 + 4
