"""Truth tables of the port's 14 gates, with the port's own keygen (TOY).

Fresh keygen and encryption cannot match peba1_tpu's draws, so these check
decryptions only; tests/test_torch_bootstrap.py holds the bootstrap itself
bit-equal to the reference on carried keys.
"""

import numpy as np
import pytest
import torch

from peba1_tpu_torch import gates, keys
from peba1_tpu_torch.backends import CipherBackend
from peba1_tpu_torch.params import TOY

# Toy sizes gain nothing from torch's intra-op threads; under several pytest
# workers on one machine those threads oversubscribe the cores (5.7x slower).
torch.set_num_threads(1)

A = np.array([0, 0, 1, 1])
B = np.array([0, 1, 0, 1])
TABLES = {
    "AND": A & B, "OR": A | B, "NAND": 1 - (A & B), "NOR": 1 - (A | B),
    "XOR": A ^ B, "XNOR": 1 - (A ^ B), "ANDNY": (1 - A) & B,
    "ANDYN": A & (1 - B), "ORNY": (1 - A) | B, "ORYN": A | (1 - B),
}


@pytest.fixture(scope="module")
def system():
    sk, ck = keys.keygen(torch.Generator().manual_seed(11), TOY, "cpu")
    gen = torch.Generator().manual_seed(12)
    return sk, ck, gates.encrypt_bits(gen, sk, A), gates.encrypt_bits(gen, sk, B)


def dec(ct, sk):
    return gates.decrypt_bits(ct, sk).numpy()


@pytest.mark.parametrize("name", sorted(TABLES))
def test_two_input_gate(system, name):
    sk, ck, ea, eb = system
    np.testing.assert_array_equal(dec(getattr(gates, name)(ck, ea, eb), sk), TABLES[name])


def test_not(system):
    sk, ck, ea, _ = system
    np.testing.assert_array_equal(dec(gates.NOT(ck, ea), sk), 1 - A)


def test_copy(system):
    sk, ck, ea, _ = system
    np.testing.assert_array_equal(dec(gates.COPY(ck, ea), sk), A)


def test_constant(system):
    sk, ck, _, _ = system
    np.testing.assert_array_equal(dec(gates.CONSTANT(ck, [1, 0, 1], (2, 3)), sk),
                                  [[1, 0, 1], [1, 0, 1]])


def test_mux(system):
    sk, ck, ea, eb = system
    gen = torch.Generator().manual_seed(13)
    c = np.array([1, 1, 0, 0])
    ec = gates.encrypt_bits(gen, sk, c)
    np.testing.assert_array_equal(dec(gates.MUX(ck, ea, eb, ec), sk), np.where(A, B, c))


def test_fused_level_matches_single_gates(system):
    """CipherBackend.level runs heterogeneous gates in one bootstrap, with
    broadcasting over the batch shape."""
    sk, ck, ea, eb = system
    be = CipherBackend(ck)
    outs = be.level([("XOR", ea, eb), ("AND", ea, eb), ("ORNY", ea, eb[0])])
    assert be.launches == 1
    np.testing.assert_array_equal(dec(outs[0], sk), TABLES["XOR"])
    np.testing.assert_array_equal(dec(outs[1], sk), TABLES["AND"])
    np.testing.assert_array_equal(dec(outs[2], sk), (1 - A) | B[0])
