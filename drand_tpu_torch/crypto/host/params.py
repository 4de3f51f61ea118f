"""BLS12-381 curve parameters and derived constants.

The port's own copy of drand_tpu/crypto/host/params.py (the port imports
nothing of the JAX package); the constants are byte-identical.

All constants here are public, standardized values (the BLS12-381 curve as used
by drand / the League of Entropy; see RFC 9380 and the IETF BLS signature
draft).  Everything derivable is *computed* at import time from the primary
parameters (p, r, x) and cross-checked by ``validate()`` — run by the test
suite — so a memory-slip in any constant is caught immediately.

Reference behavior being matched: the scheme layer of drand
(drand crypto/schemes.go:90-204) builds on kyber-bls12381, which is
this curve with the ZCash serialization convention and the RFC 9380
hash-to-curve suites BLS12381G1_XMD:SHA-256_SSWU_RO_ and
BLS12381G2_XMD:SHA-256_SSWU_RO_.
"""

# ---------------------------------------------------------------------------
# Primary parameters
# ---------------------------------------------------------------------------

# BLS parameter x ("z" in some texts).  Everything else derives from it.
X = -0xD201000000010000

# Base field modulus  p = (x-1)^2 * (x^4 - x^2 + 1) / 3 + x
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

# Subgroup order  r = x^4 - x^2 + 1   (255 bits)
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# G1 cofactor  h1 = (x-1)^2 / 3 ; effective cofactor used for clearing is 1-x.
H1 = 0x396C8C005555E1568C00AAAB0000AAAB
H_EFF_G1 = 0xD201000000010001  # == 1 - X

# Curve equations: E1/Fp: y^2 = x^3 + 4 ; E2/Fp2: y^2 = x^3 + 4*(1+u)
B1 = 4
B2 = (4, 4)  # 4*(1+u) as an Fp2 element (c0, c1)

# ---------------------------------------------------------------------------
# Generators (standard, from the BLS12-381 spec / ZCash)
# ---------------------------------------------------------------------------

G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)

G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)

# ---------------------------------------------------------------------------
# Hash-to-curve (RFC 9380) suite constants
# ---------------------------------------------------------------------------

# G1 suite BLS12381G1_XMD:SHA-256_SSWU_RO_: SSWU on the 11-isogenous curve
#   E1': y^2 = x^3 + A1*x + B1', Z = 11
ISO_A1 = 0x144698A3B8E9433D693A02C96D4982B0EA985383EE66A8D8E8981AEFD881AC98936F8DA0E0F97F5CF428082D584C1D
ISO_B1 = 0x12E2908D11688030018B12E8753EEE3B2016C1F0F24F4070A0B9C14FCEF35EF55A23215A316CEAA5D1CC48E98E172BE0
Z1 = 11

# G2 suite BLS12381G2_XMD:SHA-256_SSWU_RO_: SSWU on the 3-isogenous curve
#   E2': y^2 = x^3 + A2*x + B2', A2 = 240*u, B2' = 1012*(1+u), Z = -(2+u)
ISO_A2 = (0, 240)
ISO_B2 = (1012, 1012)
Z2 = (P - 2, P - 1)  # -(2+u)

# Domain separation tags used by drand's kyber-bls12381 (standard ciphersuite
# tags from the BLS signature draft).
DST_G2 = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_NUL_"
DST_G1 = b"BLS_SIG_BLS12381G1_XMD:SHA-256_SSWU_RO_NUL_"

# hash_to_field parameter L = ceil((ceil(log2(p)) + k) / 8), k = 128
HTF_L = 64


def validate() -> None:
    """Cross-check every primary constant; raises AssertionError on any slip."""
    x = X
    assert R == x**4 - x**2 + 1
    assert P == (x - 1) ** 2 * (x**4 - x**2 + 1) // 3 + x
    assert H1 == (x - 1) ** 2 // 3
    assert H_EFF_G1 == 1 - x
    assert P % 4 == 3  # sqrt via a^((p+1)/4)
    assert P % 6 == 1  # mu_6 in Fp (j=0 automorphisms are rational)
    assert (pow(P, 4, R) - pow(P, 2, R) + 1) % R == 0  # r | p^4 - p^2 + 1
    # generators on-curve
    gx, gy = G1_GEN
    assert (gy * gy - (gx**3 + B1)) % P == 0
    (x0, x1), (y0, y1) = G2_GEN
    # Fp2 arithmetic inline: (a0+a1 u)^2, u^2 = -1
    xx0, xx1 = (x0 * x0 - x1 * x1) % P, (2 * x0 * x1) % P
    x3_0, x3_1 = (xx0 * x0 - xx1 * x1) % P, (xx0 * x1 + xx1 * x0) % P
    yy0, yy1 = (y0 * y0 - y1 * y1) % P, (2 * y0 * y1) % P
    assert (yy0 - x3_0 - B2[0]) % P == 0 and (yy1 - x3_1 - B2[1]) % P == 0
