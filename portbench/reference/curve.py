"""BN254 in Python integers: the constants, G1 over Fq and G2 over Fq2 =
Fq[u]/(u^2 + 1), affine points as tuples and None for infinity.

Written for the benchmark from the curve's public definition (EIP-196 /
EIP-197, snarkjs' bn128): y^2 = x^3 + 3 on G1, y^2 = x^3 + 3/(9 + u) on
the twist.  Scalar multiplication runs in Jacobian coordinates with one
inversion at the end; it is slow and plainly right.
"""
from __future__ import annotations

R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583

G1 = (1, 2)
G2 = ((10857046999023057135944570762232829481370756359578518086990519993285655852781,
       11559732032986387107991004021392285783925812861821192530917403151452391805634),
      (8495653923123431417604973247489272438418190587263600148770280649306958101930,
       4082367875863433681332203403145435568316851327593401208105741076214120093531))

# r - 1 = 2^28 * odd; the 2-adic roots come from the non-residue 5
TWO_ADICITY = 28
_ROOT_2_28 = pow(5, (R - 1) >> TWO_ADICITY, R)


def root_of_unity(log_n: int) -> int:
    """The primitive 2^log_n-th root of unity of Fr that snarkjs and
    rapidsnark use (5^((r-1)/2^28) squared down)."""
    w = _ROOT_2_28
    for _ in range(TWO_ADICITY - log_n):
        w = w * w % R
    return w


class Fq:
    zero, one = 0, 1

    @staticmethod
    def add(a, b):
        return (a + b) % Q

    @staticmethod
    def sub(a, b):
        return (a - b) % Q

    @staticmethod
    def mul(a, b):
        return a * b % Q

    @staticmethod
    def inv(a):
        return pow(a, -1, Q)


class Fq2:
    zero, one = (0, 0), (1, 0)

    @staticmethod
    def add(a, b):
        return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)

    @staticmethod
    def sub(a, b):
        return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)

    @staticmethod
    def mul(a, b):
        return ((a[0] * b[0] - a[1] * b[1]) % Q,
                (a[0] * b[1] + a[1] * b[0]) % Q)

    @staticmethod
    def inv(a):
        n = pow((a[0] * a[0] + a[1] * a[1]) % Q, -1, Q)
        return (a[0] * n % Q, -a[1] * n % Q)


def field_of(point) -> type:
    return Fq2 if isinstance(point[0], tuple) else Fq


def affine_add(F, p, q):
    """Complete affine addition (doubling and inverses included)."""
    if p is None:
        return q
    if q is None:
        return p
    (x1, y1), (x2, y2) = p, q
    if x1 == x2:
        if F.add(y1, y2) == F.zero:
            return None
        three_x2 = F.mul((3, 0) if F is Fq2 else 3, F.mul(x1, x1))
        lam = F.mul(three_x2, F.inv(F.add(y1, y1)))
    else:
        lam = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
    x3 = F.sub(F.sub(F.mul(lam, lam), x1), x2)
    return (x3, F.sub(F.mul(lam, F.sub(x1, x3)), y1))


def _jac_double(F, p):
    x, y, z = p
    if z == F.zero:
        return p
    a = F.mul(x, x)
    b = F.mul(y, y)
    c = F.mul(b, b)
    t = F.add(x, b)
    d = F.sub(F.sub(F.mul(t, t), a), c)
    d = F.add(d, d)
    e = F.add(F.add(a, a), a)
    f = F.mul(e, e)
    x3 = F.sub(f, F.add(d, d))
    c8 = F.add(c, c)
    c8 = F.add(c8, c8)
    c8 = F.add(c8, c8)
    y3 = F.sub(F.mul(e, F.sub(d, x3)), c8)
    yz = F.mul(y, z)
    return (x3, y3, F.add(yz, yz))


def _jac_add_affine(F, p, q):
    """Jacobian p + affine q (q not infinity)."""
    x1, y1, z1 = p
    if z1 == F.zero:
        return (q[0], q[1], F.one)
    z1z1 = F.mul(z1, z1)
    u2 = F.mul(q[0], z1z1)
    s2 = F.mul(F.mul(q[1], z1), z1z1)
    if u2 == x1:
        if s2 == y1:
            return _jac_double(F, p)
        return (F.one, F.one, F.zero)
    h = F.sub(u2, x1)
    hh = F.mul(h, h)
    i = F.add(hh, hh)
    i = F.add(i, i)
    j = F.mul(h, i)
    rr = F.sub(s2, y1)
    rr = F.add(rr, rr)
    v = F.mul(x1, i)
    x3 = F.sub(F.sub(F.mul(rr, rr), j), F.add(v, v))
    y1j = F.mul(y1, j)
    y3 = F.sub(F.mul(rr, F.sub(v, x3)), F.add(y1j, y1j))
    zh = F.add(z1, h)
    z3 = F.sub(F.sub(F.mul(zh, zh), z1z1), hh)
    return (x3, y3, z3)


def mul(point, k: int):
    """k * point (affine or None), k reduced mod r."""
    k %= R
    if point is None or k == 0:
        return None
    F = field_of(point)
    acc = (F.one, F.one, F.zero)
    for bit in bin(k)[2:]:
        acc = _jac_double(F, acc)
        if bit == "1":
            acc = _jac_add_affine(F, acc, point)
    x, y, z = acc
    if z == F.zero:
        return None
    zi = F.inv(z)
    zi2 = F.mul(zi, zi)
    return (F.mul(x, zi2), F.mul(y, F.mul(zi2, zi)))


def on_curve(point) -> bool:
    if point is None:
        return True
    F = field_of(point)
    x, y = point
    if F is Fq:
        b = 3
    else:
        xi_inv = Fq2.inv((9, 1))
        b = Fq2.mul((3, 0), xi_inv)
    return F.sub(F.mul(y, y), F.add(F.mul(F.mul(x, x), x), b)) == F.zero


def to_json(point, g2: bool = False) -> list:
    """snarkjs' JSON of an affine point (decimal strings)."""
    if point is None:
        return ([["0", "0"], ["1", "0"], ["0", "0"]] if g2
                else ["0", "1", "0"])
    if g2:
        (xa, xb), (ya, yb) = point
        return [[str(xa), str(xb)], [str(ya), str(yb)], ["1", "0"]]
    return [str(point[0]), str(point[1]), "1"]
