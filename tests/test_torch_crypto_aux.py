"""The port's small crypto and encoding modules against the reference's:
``crypto/xchacha20poly1305.py``, ``crypto/xsalsa20.py``,
``crypto/armor.py``, ``crypto/random.py`` and ``libs/bech32.py``.

Every case of ``tests/test_crypto_aux.py`` runs once on each package (the
reference's vectors and length errors), and on seeded random inputs each
function's output is equal across the packages: HChaCha20 and HSalsa20,
the AEAD and the secretbox, the armor text and the bech32 strings, and a
message sealed by one package opens in the other.
"""

import hashlib
from types import SimpleNamespace

import numpy as np
import pytest

from tendermint_tpu.crypto import armor as r_armor
from tendermint_tpu.crypto import random as r_crand
from tendermint_tpu.crypto import xchacha20poly1305 as r_xc
from tendermint_tpu.crypto import xsalsa20 as r_xs
from tendermint_tpu.libs import bech32 as r_bech32
from tendermint_tpu_torch.crypto import armor, xchacha20poly1305, xsalsa20
from tendermint_tpu_torch.crypto import random as crand
from tendermint_tpu_torch.libs import bech32

REF = SimpleNamespace(name="reference", xc=r_xc, xs=r_xs, armor=r_armor, bech32=r_bech32,
                      crand=r_crand)
PORT = SimpleNamespace(name="port", xc=xchacha20poly1305, xs=xsalsa20, armor=armor,
                       bech32=bech32, crand=crand)
PACKAGES = [REF, PORT]


@pytest.mark.parametrize("pkg", PACKAGES, ids=lambda p: p.name)
class TestXChaCha20Poly1305:
    # hChaCha20Vectors from the reference's vector_test.go (public data)
    HCHACHA_VECTORS = [
        ("00" * 32, "00" * 16,
         "1140704c328d1d5d0e30086cdf209dbd6a43b8f41518a11cc387b669b2ee6586"),
        ("80" + "00" * 31, "00" * 16,
         "7d266a7fd808cae4c02a0a70dcbfbcc250dae65ce3eae7fc210f54cc8f77df86"),
        ("000102030405060708090a0b0c0d0e0f101112131415161718191a1b1c1d1e1f",
         "000102030405060708090a0b0c0d0e0f",
         "51e3ff45a895675c4b33b46c64f4a9ace110d34df6a2ceab486372bacbd3eff6"),
        ("24f11cce8a1b3d61e441561a696c1c1b7e173d084fd4812425435a8896a013dc",
         "d9660c5900ae19ddad28d6e06e45fe5e",
         "5966b3eec3bff1189f831f06afe4d4e3be97fa9235ec8c20d08acfbbb4e851e3"),
    ]

    def test_hchacha20_vectors(self, pkg):
        for key_h, nonce_h, want_h in self.HCHACHA_VECTORS:
            got = pkg.xc.hchacha20(bytes.fromhex(key_h), bytes.fromhex(nonce_h))
            assert got.hex() == want_h

    def test_aead_reference_vector(self, pkg):
        """The reference's TestVectors entry (vector_test.go:95)."""
        key = bytes(range(0x80, 0xA0))
        nonce = bytes([0x07, 0, 0, 0]) + bytes(range(0x40, 0x4C)) + b"\x00" * 8
        ad = bytes([0x50, 0x51, 0x52, 0x53, 0xC0, 0xC1, 0xC2, 0xC3,
                    0xC4, 0xC5, 0xC6, 0xC7])
        pt = (b"Ladies and Gentlemen of the class of '99: If I could offer "
              b"you only one tip for the future, sunscreen would be it.")
        want = bytes([
            0x45, 0x3c, 0x06, 0x93, 0xa7, 0x40, 0x7f, 0x04, 0xff, 0x4c,
            0x56, 0xae, 0xdb, 0x17, 0xa3, 0xc0, 0xa1, 0xaf, 0xff, 0x01,
            0x17, 0x49, 0x30, 0xfc, 0x22, 0x28, 0x7c, 0x33, 0xdb, 0xcf,
            0x0a, 0xc8, 0xb8, 0x9a, 0xd9, 0x29, 0x53, 0x0a, 0x1b, 0xb3,
            0xab, 0x5e, 0x69, 0xf2, 0x4c, 0x7f, 0x60, 0x70, 0xc8, 0xf8,
            0x40, 0xc9, 0xab, 0xb4, 0xf6, 0x9f, 0xbf, 0xc8, 0xa7, 0xff,
            0x51, 0x26, 0xfa, 0xee, 0xbb, 0xb5, 0x58, 0x05, 0xee, 0x9c,
            0x1c, 0xf2, 0xce, 0x5a, 0x57, 0x26, 0x32, 0x87, 0xae, 0xc5,
            0x78, 0x0f, 0x04, 0xec, 0x32, 0x4c, 0x35, 0x14, 0x12, 0x2c,
            0xfc, 0x32, 0x31, 0xfc, 0x1a, 0x8b, 0x71, 0x8a, 0x62, 0x86,
            0x37, 0x30, 0xa2, 0x70, 0x2b, 0xb7, 0x63, 0x66, 0x11, 0x6b,
            0xed, 0x09, 0xe0, 0xfd, 0x5c, 0x6d, 0x84, 0xb6, 0xb0, 0xc1,
            0xab, 0xaf, 0x24, 0x9d, 0x5d, 0xd0, 0xf7, 0xf5, 0xa7, 0xea,
        ])
        got = pkg.xc.seal(key, nonce, pt, ad)
        assert got == want
        assert pkg.xc.open_(key, nonce, got, ad) == pt

    def test_forgery_rejected(self, pkg):
        key = b"k" * 32
        nonce = b"n" * 24
        ct = bytearray(pkg.xc.seal(key, nonce, b"hello", b"ad"))
        ct[0] ^= 1
        with pytest.raises(ValueError):
            pkg.xc.open_(key, nonce, bytes(ct), b"ad")
        with pytest.raises(ValueError):
            pkg.xc.open_(key, nonce, pkg.xc.seal(key, nonce, b"hello", b"ad"), b"other-ad")

    def test_bad_lengths(self, pkg):
        with pytest.raises(ValueError):
            pkg.xc.seal(b"short", b"n" * 24, b"x")
        with pytest.raises(ValueError):
            pkg.xc.seal(b"k" * 32, b"n" * 23, b"x")


@pytest.mark.parametrize("pkg", PACKAGES, ids=lambda p: p.name)
class TestXSalsa20Symmetric:
    def test_roundtrip(self, pkg):
        """symmetric_test.go:15 TestSimple."""
        secret = b"somesecretoflengththirtytwo===32"
        pt = b"sometext"
        ct = pkg.xs.encrypt_symmetric(pt, secret)
        assert len(ct) == len(pt) + pkg.xs.NONCE_LEN + pkg.xs.OVERHEAD
        assert pkg.xs.decrypt_symmetric(ct, secret) == pt

    def test_roundtrip_with_kdf_style_secret(self, pkg):
        """symmetric_test.go:28 shape: secret = sha256(kdf output)."""
        secret = hashlib.sha256(b"somesalt" + b"somepass").digest()
        pt = b"x" * 1000
        assert pkg.xs.decrypt_symmetric(pkg.xs.encrypt_symmetric(pt, secret), secret) == pt

    def test_wrong_key_and_tamper_fail(self, pkg):
        secret = b"a" * 32
        ct = bytearray(pkg.xs.encrypt_symmetric(b"data", secret))
        with pytest.raises(ValueError):
            pkg.xs.decrypt_symmetric(bytes(ct), b"b" * 32)
        ct[-1] ^= 1
        with pytest.raises(ValueError):
            pkg.xs.decrypt_symmetric(bytes(ct), secret)

    def test_bad_secret_len_and_short_ciphertext(self, pkg):
        with pytest.raises(ValueError):
            pkg.xs.encrypt_symmetric(b"x", b"short")
        with pytest.raises(ValueError):
            pkg.xs.decrypt_symmetric(b"x" * 30, b"a" * 32)

    def test_nonce_randomized(self, pkg):
        secret = b"a" * 32
        assert pkg.xs.encrypt_symmetric(b"d", secret) != pkg.xs.encrypt_symmetric(b"d", secret)

    def test_secretbox_deterministic_layout(self, pkg):
        """tag(16) || body, decryptable via the low-level API."""
        key, nonce = b"k" * 32, b"n" * 24
        boxed = pkg.xs.secretbox_seal(b"payload", nonce, key)
        assert len(boxed) == 16 + 7
        assert pkg.xs.secretbox_open(boxed, nonce, key) == b"payload"
        assert pkg.xs.secretbox_open(boxed, b"m" * 24, key) is None


@pytest.mark.parametrize("pkg", PACKAGES, ids=lambda p: p.name)
class TestArmor:
    def test_roundtrip(self, pkg):
        """armor_test.go TestArmor shape."""
        blob = bytes(range(256)) * 3
        s = pkg.armor.encode_armor("TENDERMINT PRIVATE KEY", {"kdf": "bcrypt", "salt": "ab"}, blob)
        typ, headers, data = pkg.armor.decode_armor(s)
        assert typ == "TENDERMINT PRIVATE KEY"
        assert headers == {"kdf": "bcrypt", "salt": "ab"}
        assert data == blob

    def test_no_headers_and_empty_payload(self, pkg):
        s = pkg.armor.encode_armor("MESSAGE", {}, b"")
        typ, headers, data = pkg.armor.decode_armor(s)
        assert (typ, headers, data) == ("MESSAGE", {}, b"")

    def test_crc_mismatch_rejected(self, pkg):
        s = pkg.armor.encode_armor("MESSAGE", {}, b"hello world")
        lines = s.splitlines()
        # corrupt a body byte, keep the checksum line
        import base64 as b64

        body_i = next(i for i, ln in enumerate(lines) if ln == "") + 1
        raw = bytearray(b64.b64decode(lines[body_i]))
        raw[0] ^= 0xFF
        lines[body_i] = b64.b64encode(bytes(raw)).decode()
        with pytest.raises(ValueError):
            pkg.armor.decode_armor("\n".join(lines))

    def test_malformed(self, pkg):
        with pytest.raises(ValueError):
            pkg.armor.decode_armor("not armor at all")
        with pytest.raises(ValueError):
            pkg.armor.decode_armor("-----BEGIN A-----\n\nAAAA\n-----END B-----")


@pytest.mark.parametrize("pkg", PACKAGES, ids=lambda p: p.name)
class TestRandom:
    def test_crand_bytes_and_hex(self, pkg):
        crand = pkg.crand
        a, b = crand.c_rand_bytes(32), crand.c_rand_bytes(32)
        assert len(a) == 32 and a != b
        assert crand.c_rand_bytes(0) == b""
        h = crand.c_rand_hex(11)
        assert len(h) == 11 and all(c in "0123456789abcdef" for c in h)
        crand.mix_entropy(b"operator entropy")  # API parity, accepted
        with pytest.raises(ValueError):
            crand.c_rand_bytes(-1)


@pytest.mark.parametrize("pkg", PACKAGES, ids=lambda p: p.name)
class TestBech32:
    def test_reference_shape_roundtrip(self, pkg):
        """bech32_test.go: sha256 digest through ConvertAndEncode/back."""
        digest = hashlib.sha256(b"test").digest()
        bech = pkg.bech32.convert_and_encode("shasum", digest)
        hrp, data = pkg.bech32.decode_and_convert(bech)
        assert hrp == "shasum"
        assert data == digest

    def test_bip173_valid_vectors(self, pkg):
        # valid test strings from BIP-0173 (public spec data)
        for s in [
            "A12UEL5L",
            "an83characterlonghumanreadablepartthatcontainsthenumber1andtheexcludedcharactersbio1tt5tgs",
            "abcdef1qpzry9x8gf2tvdw0s3jn54khce6mua7lmqqqxw",
            "split1checkupstagehandshakeupstreamerranterredcaperred2y9e3w",
        ]:
            hrp, data = pkg.bech32.bech32_decode(s)
            assert pkg.bech32.bech32_encode(hrp, data) == s.lower()

    def test_invalid_rejected(self, pkg):
        for s in [
            "split1cheo2y9e2w",      # bad checksum
            "1nwldj5",               # empty hrp
            "abc1rzg",               # too-short data part
            "Abc1qpzry9x8gf2tvdw0",  # mixed case... lowercase+upper A
        ]:
            with pytest.raises(ValueError):
                pkg.bech32.bech32_decode(s)

    def test_convert_bits_incomplete_group(self, pkg):
        with pytest.raises(ValueError):
            pkg.bech32.convert_bits([1], 5, 8, False)


# -- the packages against each other ------------------------------------------


def _rng(seed):
    return np.random.default_rng(seed)


def _bytes(rng, n):
    return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("seed", range(4))
def test_ciphers_equal_on_seeded_inputs(seed):
    rng = _rng(seed)
    for n in (0, 1, 15, 16, 17, 63, 64, 65, 200):
        key, nonce, ad, pt = _bytes(rng, 32), _bytes(rng, 24), _bytes(rng, 7), _bytes(rng, n)
        assert xchacha20poly1305.hchacha20(key, nonce[:16]) == r_xc.hchacha20(key, nonce[:16])
        assert xsalsa20.hsalsa20(key, nonce[:16]) == r_xs.hsalsa20(key, nonce[:16])
        sealed = xchacha20poly1305.seal(key, nonce, pt, ad)
        assert sealed == r_xc.seal(key, nonce, pt, ad)
        assert r_xc.open_(key, nonce, sealed, ad) == pt
        boxed = xsalsa20.secretbox_seal(pt, nonce, key)
        assert boxed == r_xs.secretbox_seal(pt, nonce, key)
        assert r_xs.secretbox_open(boxed, nonce, key) == pt
        if n:
            # a random nonce each: what one package encrypts the other decrypts
            assert r_xs.decrypt_symmetric(xsalsa20.encrypt_symmetric(pt, key), key) == pt
            assert xsalsa20.decrypt_symmetric(r_xs.encrypt_symmetric(pt, key), key) == pt


@pytest.mark.parametrize("seed", range(2))
def test_armor_and_bech32_equal_on_seeded_inputs(seed):
    rng = _rng(100 + seed)
    for n in (0, 1, 2, 3, 47, 48, 49, 200):
        data = _bytes(rng, n)
        headers = {"kdf": "bcrypt", "salt": data[:4].hex()} if n % 2 else {}
        text = armor.encode_armor("TENDERMINT PRIVATE KEY", headers, data)
        assert text == r_armor.encode_armor("TENDERMINT PRIVATE KEY", headers, data)
        assert r_armor.decode_armor(text) == armor.decode_armor(text)
        if n <= 50:  # a bech32 string holds at most 90 characters
            bech = bech32.convert_and_encode("tm", data)
            assert bech == r_bech32.convert_and_encode("tm", data)
            assert r_bech32.decode_and_convert(bech) == bech32.decode_and_convert(bech)


def test_length_errors_equal():
    cases = [
        (lambda m: m.hchacha20(b"k" * 31, b"n" * 16)),
        (lambda m: m.hchacha20(b"k" * 32, b"n" * 15)),
        (lambda m: m.open_(b"k" * 32, b"n" * 24, b"x" * 15)),
    ]
    for case in cases:
        got = []
        for m in (xchacha20poly1305, r_xc):
            with pytest.raises(ValueError) as ei:
                case(m)
            got.append(str(ei.value))
        assert got[0] == got[1]
    for m in (xsalsa20, r_xs):
        with pytest.raises(ValueError, match="secret must be 32 bytes, got 5"):
            m.encrypt_symmetric(b"x", b"short")
        with pytest.raises(ValueError, match="ciphertext is too short"):
            m.decrypt_symmetric(b"x" * 40, b"a" * 32)
