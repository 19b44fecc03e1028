"""The port's sharded batch verification
(`lodestar_tpu_torch.models.batch_verify`: `_shard_partials`,
`_shard_finish`, `device_batch_verify_sharded`, the single-launch shard
road, `verify_signature_sets_sharded`, `make_mesh_sharded_fn`), held
against the JAX package on the CPU, with every shard on a "cpu" device
(the port's counterpart of the JAX package's virtual device mesh).

Tolerance: none. The shard partials must equal the JAX pieces limb for
limb on the same inputs and blinding bits; verdicts must be equal. Both
packages get the JAX package's host prep (numpy arrays) and the same
`coeff_bits`; batches are padded to size 8, the program the JAX package's
own batch-verify tests compile. The single-launch shard road (prep legs
plus partials, one counted dispatch a shard, then the finish) is held
against the split road on the same bits, and its partials against the
eager road's, limb for limb.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lodestar_tpu.models import batch_verify as jbv
from lodestar_tpu.ops import curve as jcv
from lodestar_tpu.ops import fp as jfp
from lodestar_tpu.ops import pairing as jprg
from lodestar_tpu.ops import tower as jtw
from lodestar_tpu_torch.models import batch_verify as bv
from lodestar_tpu_torch.ops import prep as dp

SIZE = 8  # the size class of every batch here
CPU2 = ["cpu", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _one_aten_thread():
    """ATen on one thread for this module: the tensors are small, so its
    worker threads only spin against other processes."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _restore_modes():
    yield
    bv.configure_single_launch("auto")
    bv.configure_device_prep("auto")


@pytest.fixture(scope="module")
def sets5():
    return jbv.make_synthetic_sets(5, seed=3)


def _cases(sets5):
    valid = list(sets5[:4])
    tampered = list(valid)
    tampered[2] = dataclasses.replace(tampered[2], signature=sets5[4].signature)
    swapped = list(valid)
    swapped[0] = dataclasses.replace(swapped[0], message=sets5[1].message)
    return {"valid": valid, "tampered": tampered, "swapped": swapped, "n5": list(sets5)}


def _bits(n, seed):
    """Blinding bits for n sets padded to SIZE: 1, then nonzero 64-bit
    scalars from a fixed seed (what `_blinding_and_mask` draws from
    os.urandom)."""
    r = np.random.default_rng(seed)
    bits = np.zeros((SIZE, bv.COEFF_BITS), dtype=np.int32)
    bits[0, -1] = 1
    bits[1:n] = r.integers(0, 2, size=(n - 1, bv.COEFF_BITS), dtype=np.int32)
    bits[1:n, 0] = 1
    return bits


def _jax_partials(pk_x, pk_y, h_x, h_y, sig_x, sig_y, bits, mask):
    """The JAX `shard_fn`'s local half (`batch_verify.py:632-652`), from the
    JAX package's own pieces."""
    import jax.numpy as jnp

    rpk = jcv.scalar_mul_var(jcv.F1, (pk_x, pk_y), bits, jfp.one_mont())
    rsig = jcv.scalar_mul_var(jcv.F2, (sig_x, sig_y), bits, jtw.fp2_one())
    mcol = mask[:, None, None]
    rsig = (rsig[0], rsig[1], jnp.where(mcol, rsig[2], jnp.zeros_like(rsig[2])))
    local_sig = jcv.fold_sum(jcv.F2, rsig)
    rpk_aff = jcv.jac_to_affine_batch(jcv.F1, rpk)
    gen_px, gen_py = jnp.asarray(jbv._NEG_G1_X), jnp.asarray(jbv._NEG_G1_Y)
    p_x = jnp.where(mcol[..., 0], rpk_aff[0], gen_px)
    p_y = jnp.where(mcol[..., 0], rpk_aff[1], gen_py)
    q_x = jnp.where(mcol, h_x, h_x[0])
    q_y = jnp.where(mcol, h_y, h_y[0])
    fs = jprg.miller_loop((p_x, p_y), (q_x, q_y))
    return (jprg.fp12_product_fold(fs, mask=mask), *local_sig)


def test_shard_partials_match_the_jax_pieces(sets5):
    """A 4-row shard with three padding rows (rows 4-7 of 5 sets padded to
    8): the Fp12 product and the Jacobian G2 partial sum, limb for limb."""
    pk, h, sig, _, mask = jbv.build_device_inputs(sets5, size=SIZE, prep="off")
    bits = _bits(5, 11)
    sl = slice(4, 8)
    cols = [np.asarray(c)[sl] for c in (pk[0], pk[1], h[0], h[1], sig[0], sig[1])]
    cols += [bits[sl], np.asarray(mask)[sl]]
    assert cols[-1].tolist() == [True, False, False, False]
    want = _jax_partials(*cols)
    got = bv._shard_partials(*(torch.as_tensor(np.ascontiguousarray(c)) for c in cols))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case,want", [("valid", True), ("tampered", False),
                                       ("swapped", False), ("n5", True)])
def test_sharded_core_matches_the_single_device_verifies(case, want, sets5):
    """`device_batch_verify_sharded` over two "cpu" shards of 4 rows equals
    the port's `device_batch_verify` and the JAX `device_batch_verify` on the
    same inputs and bits (n5: 5 sets padded to 8, the second shard one real
    row and three padding rows)."""
    sets = _cases(sets5)[case]
    pk, h, sig, _, mask = jbv.build_device_inputs(sets, size=SIZE, prep="off")
    bits = _bits(len(sets), 7)
    jax_ok = bool(np.asarray(jbv.device_batch_verify(pk, h, sig, bits, mask)))
    inputs = bv.inputs_from_numpy(pk, h, sig, bits, mask, device="cpu")
    single = bv.device_batch_verify(*inputs)
    sharded = bv.device_batch_verify_sharded(CPU2, *inputs)
    assert sharded.dtype == torch.bool and sharded.shape == ()
    assert bool(sharded) is bool(single) is jax_ok is want


def test_single_launch_shard_road_matches_the_split_road(sets5):
    """The single-launch shard road on two "cpu" shards: n_shards + 1
    counted dispatches, the split road's verdict on the same bits, and
    shard partials limb-equal to the eager road's on the same device-prepped
    inputs."""
    sets = _cases(sets5)["valid"]
    bits = _bits(4, 5)
    si = bv.prepare_single_launch_inputs(sets, coeff_bits=bits, size=SIZE)
    base = dp.prep_launches_total()
    parts = bv._shard_replays(si, [torch.device("cpu")] * 2)
    verdict = bv._finish_launch(parts, torch.device("cpu"))
    assert dp.prep_launches_total() - base == 2 + 1
    assert bool(verdict) and all(bool(p[6]) for p in parts)

    pk, h, sig, ebits, mask = bv.build_device_inputs(sets, device="cpu", coeff_bits=bits,
                                                     prep="on")
    eager = bv._eager_shard_partials([torch.device("cpu")] * 2, pk, h, sig, ebits, mask)
    for shard, (g, e) in enumerate(zip(parts, eager)):
        for i, (a, b) in enumerate(zip(g[:4], e)):
            assert torch.equal(a, b), (shard, i)
    assert torch.equal(parts[0][4], h[0][0]) and torch.equal(parts[0][5], h[1][0])
    gathered = bv._gather_partials(eager, (h[0][0], h[1][0]), torch.device("cpu"))
    assert bool(bv._shard_finish(*gathered)) is True


def test_single_launch_shard_road_rejects_a_swapped_batch(sets5):
    """Swapped signatures (valid points, failed pairing check) through the
    single-launch shard road: False, as the split road says on the same
    bits, with every shard's batch_valid True."""
    valid = _cases(sets5)["valid"]
    swapped = list(valid)
    swapped[1] = dataclasses.replace(valid[1], signature=valid[3].signature)
    swapped[3] = dataclasses.replace(valid[3], signature=valid[1].signature)
    bits = _bits(4, 9)
    base = dp.prep_launches_total()
    bv.configure_single_launch("on")
    assert bv.verify_signature_sets_sharded(swapped, CPU2, coeff_bits=bits) is False
    assert dp.prep_launches_total() - base == 3
    bv.configure_single_launch("off")
    assert bv.verify_signature_sets_sharded(swapped, CPU2, coeff_bits=bits) is False


def test_wrong_length_is_false_with_zero_dispatches(sets5):
    bad = list(sets5[:4])
    bad[2] = dataclasses.replace(bad[2], signature=bad[2].signature[:-1])
    bv.configure_single_launch("on")
    base = dp.prep_launches_total()
    assert bv.verify_signature_sets_sharded(bad, CPU2) is False
    assert dp.prep_launches_total() == base


def test_a_shard_fault_propagates(sets5, monkeypatch):
    """An error in a shard body, or in the finish, raises out of
    `verify_signature_sets_sharded`: nothing falls back."""
    bv.configure_single_launch("on")

    def broken(*args):
        raise RuntimeError("injected shard fault")

    monkeypatch.setattr(bv, "_single_launch_shard", broken)
    with pytest.raises(RuntimeError, match="injected shard fault"):
        bv.verify_signature_sets_sharded(sets5[:4], CPU2)

    def stub_shard(*args):
        """Partials of the right shapes (the finish never reads them)."""
        mask = args[-1]
        f = torch.zeros((2, 3, 2, 33), dtype=torch.int32)
        pt = torch.zeros((2, 33), dtype=torch.int32)
        return f, pt, pt, pt, pt, pt, torch.all(mask | ~mask)

    def broken_finish(*args):
        raise RuntimeError("injected finish fault")

    base = dp.prep_launches_total()
    monkeypatch.setattr(bv, "_single_launch_shard", stub_shard)
    monkeypatch.setattr(bv, "_shard_finish_body", broken_finish)
    with pytest.raises(RuntimeError, match="injected finish fault"):
        bv.verify_signature_sets_sharded(sets5[:4], CPU2)
    assert dp.prep_launches_total() - base == 3  # two shards, then the finish


def test_sharded_padding_rule():
    """The JAX package's rule (`batch_verify.py:1071-1075`): the pow-2 class,
    at least one row a device, a multiple of the device count."""
    for n, n_dev in [(1, 2), (5, 2), (8, 8), (9, 2), (3, 3), (8, 3), (20, 16), (2048, 2)]:
        want = max(jbv._pad_pow2(n), n_dev)
        if want % n_dev:
            want += n_dev - want % n_dev
        assert bv._sharded_size(n, n_dev) == want
    assert [s.indices(9) for s in bv._shard_slices(9, 3)] == [(0, 3, 1), (3, 6, 1), (6, 9, 1)]
    with pytest.raises(ValueError):
        bv._shard_slices(8, 3)


def test_mesh_sharded_fn_needs_two_devices_and_sorts_them(monkeypatch):
    seen = []
    monkeypatch.setattr(bv, "verify_signature_sets_sharded",
                        lambda sets, devices: seen.append(list(devices)) or True)
    fn = bv.make_mesh_sharded_fn()
    with pytest.raises(ValueError):
        fn([], [1])
    assert fn([], [3, 0, 2]) is True
    assert seen[-1] == [torch.device("cuda", i) for i in (0, 2, 3)]
    mapped = bv.make_mesh_sharded_fn(devices=["cpu", "cpu", "meta"])
    assert mapped([], [2, 1]) is True
    assert seen[-1] == [torch.device("cpu"), torch.device("meta")]


def test_warm_sharded_has_nothing_to_capture_on_cpu_devices():
    """`warm_sharded` captures only CUDA devices' graphs: on "cpu" shards the
    bodies run eagerly, so it captures nothing; below two devices it
    raises, as the sharded verify does."""
    before = bv._SHARD_GRAPHS.captures + bv._SHARD_FINISH_GRAPHS.captures
    assert bv.warm_sharded(CPU2, [32, 128]) == {}
    assert bv._SHARD_GRAPHS.captures + bv._SHARD_FINISH_GRAPHS.captures == before
    with pytest.raises(ValueError):
        bv.warm_sharded(["cpu"], [32])


def test_verdicts_match_the_jax_sharded_verify_on_eight_devices():
    """The JAX package's `verify_signature_sets_sharded` on the 8-device
    virtual CPU mesh (`tests/conftest.py`) and the port's on 8 "cpu" shards
    of one row each, at 8 sets (the shape `tests/models/test_batch_verify.py`
    compiles): both True. Each side draws its own blinding; the verdict of
    a valid batch does not depend on it."""
    import jax
    from jax.sharding import Mesh

    mesh = Mesh(np.asarray(jax.devices("cpu")[:8]), ("data",))
    sets = jbv.make_synthetic_sets(8, seed=21)
    assert jbv.verify_signature_sets_sharded(sets, mesh) is True
    assert bv.verify_signature_sets_sharded(sets, ["cpu"] * 8) is True


@pytest.mark.slow
def test_shard_rows_are_the_graph_bodies_row_counts():
    """`chip_smoke.SHARD_ROWS` is the union of the row counts the shard body
    launches the kernels at, at shard classes 1,024 and 64, and the finish
    at two shards, counted on meta tensors (about 40 s a class here)."""
    import chip_smoke

    from lodestar_tpu_torch.ops import fp_cuda

    seen = set()
    for shard_class in (1024, 64):
        rows = chip_smoke.shard_rows_on_meta(shard_class, 2)
        assert all(rows[k] for k in fp_cuda.KERNELS)
        seen |= {n for r in rows.values() for n in r}
    assert seen == set(chip_smoke.SHARD_ROWS)
    assert set(chip_smoke.SHARD_ROWS) <= set(chip_smoke.N_KERNEL_CHECK)
