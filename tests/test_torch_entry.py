"""The port's entry points (distributed_grep_tpu_torch/entry.py) against
the repository's ``__graft_entry__.py``: ``entry()``'s function is the
reference's on the same stripes, mapped to the port's words, and
``dryrun_multichip`` over four host entries prints its OK line with the
reference's mode list.  The tolerance is zero.
"""

from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import torch

import __graft_entry__ as ref_entry
from distributed_grep_tpu_torch import entry as port_entry
from distributed_grep_tpu_torch.ops.fdr_scan import pack_bits


def test_example_document_is_the_references():
    assert port_entry._example_doc() == ref_entry._example_doc()


def test_entry_fn_equals_the_references_on_its_example():
    """K1 over the example's stripes: the reference's ``entry()`` function
    (its XLA table-DFA scan) on the same bytes, its (chunk, lanes // 8)
    bits as the port's (chunk // 32, lanes) words."""
    fn, (st,) = port_entry.entry(device="cpu")
    assert st.device.type == "cpu" and st.dtype == torch.uint8
    ref_fn, (ref_arr,) = ref_entry.entry()
    got = fn(st)
    packed = np.asarray(ref_fn(jnp.asarray(st.numpy().T.copy())))
    bits = np.unpackbits(packed, axis=1, bitorder="little").astype(bool)
    want = pack_bits(torch.from_numpy(bits))
    assert torch.equal(got, want)
    assert int(torch.count_nonzero(got.view(torch.int32))) > 0
    assert tuple(ref_arr.shape) == (152, 64)  # the reference's own layout


def test_dryrun_multichip_prints_the_ok_line(capsys):
    line = port_entry.dryrun_multichip(4, devices=["cpu"] * 4)
    out = capsys.readouterr().out.strip()
    assert out == line and line.startswith("dryrun_multichip OK: ")
    assert "mesh={'data': 2, 'seq': 2}" in line
    assert ("mesh_modes=['shift_and', 'nfa', 'fdr', 'approx', 'pairset', "
            "'nfa']") in line
    assert int(re.search(r"ep_matches=(\d+)", line).group(1)) >= 1
    assert int(re.search(r" matches=(\d+)", line).group(1)) >= 1
    assert "ranks=1 cards=1" in line


def test_dryrun_multichip_on_a_one_axis_mesh_and_too_few_devices(capsys):
    line = port_entry.dryrun_multichip(3, devices=["cpu"] * 3)
    assert "mesh={'data': 3}" in line and "ep_matches=None" in line
    try:
        port_entry.dryrun_multichip(4, devices=["cpu"] * 2)
    except ValueError as e:
        assert "need 4 devices, have 2" in str(e)
    else:
        raise AssertionError("dryrun_multichip ran with too few devices")
