"""The Groth16 quotient in plain PyTorch: the R1CS scatter, three
inverse-NTT / odd-coset / NTT round trips and the product, as snarkjs and
rapidsnark define the H MSM's scalars.

a, b = the A and B rows evaluated at the witness over the domain {w^c};
c = a * b pointwise; each of a, b, c is interpolated and evaluated on the
odd coset {g w^j} (g^2 = w, g a primitive 2n-th root); then h_j = (a'_j
b'_j - c'_j) * 2^-512 mod r, the 2^-512 being the wire scale the zkey's H
points carry (a snarkjs key bakes R^2 into them).  Radix-2 transforms,
values in the Montgomery domain of `field.Field`.
"""
from __future__ import annotations

import torch

from .curve import R, root_of_unity
from .field import Field

H_SCALE = pow(1 << 512, -1, R)


def _bitrev(log_n: int, device) -> torch.Tensor:
    idx = torch.arange(1 << log_n, device=device)
    rev = torch.zeros_like(idx)
    for bit in range(log_n):
        rev |= ((idx >> bit) & 1) << (log_n - 1 - bit)
    return rev


class Domain:
    """Twiddles of one domain size: powers of w and w^-1 (n / 2 each) and
    of the coset generator g (n), Montgomery form."""

    def __init__(self, F: Field, log_n: int):
        self.F, self.log_n, self.n = F, log_n, 1 << log_n
        w = root_of_unity(log_n)
        mont = lambda v: F.to_mont(F.tensor([v % R]))
        half = max(1, self.n // 2)
        self.fwd = F.powers(mont(w), half)
        self.inv = F.powers(mont(pow(w, -1, R)), half)
        self.coset = F.powers(mont(root_of_unity(log_n + 1)), self.n)
        self.n_inv = F.const(pow(self.n, -1, R) * F.r_mod % R, 1)
        self.rev = _bitrev(log_n, F.device)

    def ntt(self, x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
        """X_k = sum_j x_j w^(jk) (w^-1 and a 1/n scale for the inverse);
        x [16, n] Montgomery."""
        F, n = self.F, self.n
        tw = self.inv if inverse else self.fwd
        x = x[:, self.rev]
        h = 1
        while h < n:
            t = tw[:, ::n // (2 * h)][:, :h]
            v = x.reshape(16, n // (2 * h), 2, h)
            u, s = v[:, :, 0], F.mul(v[:, :, 1], t[:, None, :])
            x = torch.stack([F.add(u, s), F.sub(u, s)], dim=2).reshape(16, n)
            h *= 2
        return F.mul(x, self.n_inv) if inverse else x

    def to_odd_coset(self, x: torch.Tensor) -> torch.Tensor:
        return self.ntt(self.F.mul(self.ntt(x, inverse=True), self.coset))


def scatter(F: Field, w_std: torch.Tensor, coef_m, coef_c, coef_s,
            coef_mont: torch.Tensor, n: int):
    """a[c] += w[s] * coef (m == 0), b[c] likewise (m == 1): standard-form
    [16, n] each.  coef_* int64 tensors; coef_mont [16, n_coefs]."""
    prod = F.mul(w_std[:, coef_s], coef_mont)         # standard form
    acc = torch.zeros((16, 2 * n), dtype=torch.int64, device=F.device)
    acc.index_add_(1, coef_m * n + coef_c, prod)
    ab = F.wide_sum(acc)
    return ab[:, :n].contiguous(), ab[:, n:].contiguous()


def quotient(F: Field, dom: Domain, a_std, b_std) -> torch.Tensor:
    """The H MSM's scalars, standard form [16, n]."""
    a, b = F.to_mont(a_std), F.to_mont(b_std)
    c = F.mul(a, b)
    a2, b2, c2 = (dom.to_odd_coset(v) for v in (a, b, c))
    h = F.sub(F.mul(a2, b2), c2)
    return F.mul(h, F.const(H_SCALE, 1))
