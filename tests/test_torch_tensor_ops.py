"""Port parity for the rest of `ops/tensor.py` (elementwise, reductions,
products, ordering, losses, shape and index, assignment) against the JAX
reference on the CPU.

Each new name (aliases included) is a case of `test_op_parity`: the same
numpy-seeded inputs go through `mx.nd.<name>` of both packages (values,
shapes and dtypes), through each package's op function under its own
autodiff (the reference's `jax.vjp`, the port's `torch.autograd.grad`)
with the same cotangent where the reference's op is differentiable, and
through `sym.<name>`'s shape inference (the reference's `infer_shape`).
The named corner cases follow: ties in sort / argsort / topk, half-way
values in round and rint, the divisor's sign in `_mod`, negative-step
slices, the functional slice assignment. Mirrors tests/test_operator.py's
test_gather_scatter_nd, test_sort_argsort_topk, test_khatri_rao,
test_sequence_ops, test_smooth_l1 and tests/test_op_parity.py.

Tolerances: index, shape and ordering results exact (their gradients,
sums of cotangents in each package's order, 1e-6); arithmetic 1e-6;
transcendental functions 1e-5 (libm differences), their gradients too;
dtypes must match.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops import registry as ref_registry

import mxnet_tpu_torch as tmx
import torch
from mxnet_tpu_torch.ops import registry as port_registry

EXACT = dict(rtol=0, atol=0)
ARITH = dict(rtol=1e-6, atol=1e-6)
TRANS = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def rnd(rs, *shape, lo=-1.0, hi=1.0):
    return rs.uniform(lo, hi, shape).astype(np.float32)


def ints(rs, *shape, lo=0, hi=5):
    return rs.randint(lo, hi, shape).astype(np.int32)


def signed_away(rs, *shape, lo=0.2, hi=3.0):
    """Values of both signs with |x| in [lo, hi] (no zero)."""
    return (rnd(rs, *shape, lo=lo, hi=hi)
            * rs.choice([-1.0, 1.0], shape).astype(np.float32))


def _outs(res):
    return list(res) if isinstance(res, (tuple, list)) else [res]


def run_nd(name, arrays, params):
    """mx.nd.<name> of both packages on the same arrays: (ref, port)
    lists of numpy outputs."""
    ref = getattr(mx.nd, name)(*[mx.nd.array(a, dtype=a.dtype)
                                 for a in arrays], **params)
    port = getattr(tmx.nd, name)(*[tmx.nd.array(a, dtype=a.dtype)
                                   for a in arrays], **params)
    return ([o.asnumpy() for o in _outs(ref)],
            [o.asnumpy() for o in _outs(port)])


def check_values(name, arrays, params, tol):
    ref, port = run_nd(name, arrays, params)
    assert len(ref) == len(port), name
    for r, p in zip(ref, port):
        assert p.shape == r.shape, (name, p.shape, r.shape)
        assert p.dtype == r.dtype, (name, p.dtype, r.dtype)
        np.testing.assert_allclose(p, r, err_msg=name, **tol)
    return ref, port


def vjp_both(name, arrays, params, seed=0):
    """The gradients of <cotangent, op(arrays)> with respect to each float
    input under each package's autodiff ({input index: (ref, port)})."""
    fl = [i for i, a in enumerate(arrays) if a.dtype.kind == "f"]
    ref_fn = ref_registry.get(name).fn
    port_fn = port_registry.get(name).fn
    jx = [jnp.asarray(a) for a in arrays]

    def f(*xs):
        full = list(jx)
        for i, x in zip(fl, xs):
            full[i] = x
        return ref_fn(*full, **params)

    out, vjp = jax.vjp(f, *[jx[i] for i in fl])
    outs = _outs(out)
    rs = np.random.RandomState(seed + 100)
    cts = [np.asarray(rs.randn(*o.shape), np.float32) for o in outs]
    ref_g = vjp(tuple(jnp.asarray(c) for c in cts) if isinstance(
        out, (tuple, list)) else jnp.asarray(cts[0]))
    ts = [torch.tensor(a, requires_grad=(i in fl))
          for i, a in enumerate(arrays)]
    pouts = _outs(port_fn(*ts, **params))
    pairs = [(o, torch.from_numpy(c)) for o, c in zip(pouts, cts)
             if o.requires_grad]
    if pairs:
        port_g = torch.autograd.grad([o for o, _ in pairs],
                                     [ts[i] for i in fl],
                                     [c for _, c in pairs],
                                     allow_unused=True)
    else:
        port_g = [None] * len(fl)
    res = {}
    for i, rg, pg in zip(fl, ref_g, port_g):
        pg = np.zeros(arrays[i].shape, np.float32) if pg is None \
            else pg.numpy()
        res[i] = (np.asarray(rg), pg)
    return res


def check_grads(name, arrays, params, tol):
    for i, (rg, pg) in vjp_both(name, arrays, params).items():
        assert pg.shape == rg.shape, (name, i)
        np.testing.assert_allclose(pg, rg, err_msg="%s grad %d" % (name, i),
                                   **tol)


def check_symbol_shapes(name, arrays, params):
    """sym.<name> over variables of the arrays' shapes: the inferred
    output shapes of both packages."""
    names = ["x%d" % i for i in range(len(arrays))]
    shapes = {n: a.shape for n, a in zip(names, arrays)}
    with mx.name.NameManager():
        rs = getattr(mx.sym, name)(*[mx.sym.Variable(n) for n in names],
                                   **params)
    with tmx.name.NameManager():
        ps = getattr(tmx.sym, name)(*[tmx.sym.Variable(n) for n in names],
                                    **params)
    _, rout, _ = rs.infer_shape(**shapes)
    _, pout, _ = ps.infer_shape(**shapes)
    assert [tuple(s) for s in pout] == [tuple(s) for s in rout], (
        name, pout, rout)


def check_case(name, arrays, params, tol):
    """Values, dtypes, gradients (where the reference differentiates) and
    Symbol shapes of one op case."""
    check_values(name, arrays, params, tol)
    if ref_registry.get(name).differentiable:
        # a gradient sums cotangents (a broadcast's, a gather's), in an
        # order each package picks: arithmetic's 1e-6 at the least
        check_grads(name, arrays, params, ARITH if tol is EXACT else tol)
    check_symbol_shapes(name, arrays, params)


# ---------------------------------------------------------------------------
# the cases: name -> fn(RandomState) -> (arrays, params, tolerance)
# ---------------------------------------------------------------------------

_DOMAINS = {
    "sin": (-3, 3), "cos": (-3, 3), "tan": (-1.2, 1.2),
    "arcsin": (-0.9, 0.9), "arccos": (-0.9, 0.9), "arctan": (-3, 3),
    "sinh": (-3, 3), "cosh": (-3, 3), "arcsinh": (-3, 3),
    "arccosh": (1.1, 4), "arctanh": (-0.9, 0.9), "degrees": (-3, 3),
    "radians": (-200, 200), "erf": (-2, 2), "erfinv": (-0.9, 0.9),
    "gamma": (0.2, 5), "gammaln": (0.2, 5), "log10": (0.1, 5),
    "log2": (0.1, 5), "log1p": (-0.5, 5), "expm1": (-2, 2),
}
_ROUNDING = ("floor", "ceil", "round", "rint", "fix", "trunc")

CASES = {}
for _n, (_lo, _hi) in _DOMAINS.items():
    CASES[_n] = (lambda lo, hi: lambda rs: (
        [rnd(rs, 3, 4, 5, lo=lo, hi=hi)], {}, TRANS))(_lo, _hi)
for _n in _ROUNDING:
    CASES[_n] = lambda rs: ([rnd(rs, 4, 6, lo=-5, hi=5)], {}, ARITH)
for _n in ("cbrt", "rcbrt"):
    CASES[_n] = lambda rs: ([signed_away(rs, 3, 7)], {}, TRANS)


def _with_specials(rs):
    x = rnd(rs, 4, 5, lo=-2, hi=2)
    x[0, 0], x[1, 2], x[2, 3], x[3, 1] = np.nan, np.inf, -np.inf, 0.0
    return [x], {}, EXACT


for _n in ("isnan", "isinf", "logical_not"):
    CASES[_n] = _with_specials


def _logical_pair(rs):
    a = rs.choice([0.0, 1.5, -2.0], (3, 4)).astype(np.float32)
    b = rs.choice([0.0, 3.0], (3, 4)).astype(np.float32)
    return [a, b], {}, EXACT


def _logical_bcast(rs):
    a = rs.choice([0.0, 1.5, -2.0], (3, 4)).astype(np.float32)
    b = rs.choice([0.0, 3.0], (1, 4)).astype(np.float32)
    return [a, b], {}, EXACT


for _op in ("and", "or", "xor"):
    CASES["_logical_" + _op] = _logical_pair
    CASES["broadcast_logical_" + _op] = _logical_bcast
    for _s in (0.0, 2.0):
        CASES["_logical_%s_scalar/%g" % (_op, _s)] = (
            lambda s: lambda rs: (
                [rs.choice([0.0, 1.5, -2.0], (3, 4)).astype(np.float32)],
                {"scalar": s}, EXACT))(_s)

CASES.update({
    "_mod": lambda rs: ([signed_away(rs, 3, 4, hi=9), signed_away(rs, 3, 4)],
                        {}, TRANS),
    "broadcast_mod": lambda rs: ([signed_away(rs, 3, 4, hi=9),
                                  signed_away(rs, 1, 4)], {}, TRANS),
    "_mod_scalar": lambda rs: ([signed_away(rs, 3, 4, hi=9)],
                               {"scalar": -2.5}, TRANS),
    "_rmod_scalar": lambda rs: ([signed_away(rs, 3, 4)], {"scalar": 7.0},
                                TRANS),
    "_hypot": lambda rs: ([rnd(rs, 3, 4), rnd(rs, 3, 4)], {}, TRANS),
    "broadcast_hypot": lambda rs: ([rnd(rs, 3, 4), rnd(rs, 3, 1)], {}, TRANS),
    "_hypot_scalar": lambda rs: ([rnd(rs, 3, 4)], {"scalar": 1.5}, TRANS),
    "quadratic": lambda rs: ([rnd(rs, 3, 4)], {"a": 2.0, "b": -3.0, "c": 1.0},
                             ARITH),
    # reductions
    "prod": lambda rs: ([rnd(rs, 3, 4, 5, lo=0.5, hi=1.5)],
                        {"axis": (0, 2)}, TRANS),
    "prod/exclude": lambda rs: ([rnd(rs, 3, 4, 5, lo=0.5, hi=1.5)],
                                {"axis": 1, "exclude": True,
                                 "keepdims": True}, TRANS),
    "prod/int32": lambda rs: ([ints(rs, 3, 4, lo=1, hi=4)], {"axis": 1},
                              EXACT),
    "nansum": lambda rs: (_nan_holes(rnd(rs, 3, 4, 5)), {"axis": 1}, ARITH),
    "nanprod": lambda rs: (_nan_holes(rnd(rs, 3, 4, 5, lo=0.5, hi=1.5)),
                           {"axis": (1, 2), "keepdims": True}, TRANS),
    "square_sum": lambda rs: ([rnd(rs, 3, 4, 5)], {"axis": 1}, ARITH),
    "L2Normalization": lambda rs: ([rnd(rs, 2, 3, 4, 5)], {}, TRANS),
    "L2Normalization/channel": lambda rs: ([rnd(rs, 2, 3, 4, 5)],
                                           {"mode": "channel"}, TRANS),
    "L2Normalization/spatial": lambda rs: ([rnd(rs, 2, 3, 4, 5)],
                                           {"mode": "spatial", "eps": 1e-3},
                                           TRANS),
    # products
    "dot": lambda rs: ([rnd(rs, 3, 4), rnd(rs, 4, 5)], {}, TRANS),
    "dot/transposed": lambda rs: ([rnd(rs, 4, 3), rnd(rs, 5, 4)],
                                  {"transpose_a": True, "transpose_b": True},
                                  TRANS),
    "dot/rank3": lambda rs: ([rnd(rs, 2, 3, 4), rnd(rs, 4, 5)], {}, TRANS),
    "dot/rank3_transposed": lambda rs: ([rnd(rs, 4, 3, 2), rnd(rs, 4, 5)],
                                        {"transpose_a": True}, TRANS),
    "dot/vectors": lambda rs: ([rnd(rs, 6), rnd(rs, 6)], {}, TRANS),
    "batch_dot": lambda rs: ([rnd(rs, 2, 3, 4), rnd(rs, 2, 5, 4)],
                             {"transpose_b": True}, TRANS),
    "_matmul": lambda rs: ([rnd(rs, 2, 3, 4), rnd(rs, 4, 5)], {}, TRANS),
    "add_n": lambda rs: ([rnd(rs, 3, 4), rnd(rs, 3, 4), rnd(rs, 3, 4)], {},
                         ARITH),
    "khatri_rao": lambda rs: ([rnd(rs, 2, 3), rnd(rs, 4, 3), rnd(rs, 2, 3)],
                              {}, ARITH),
    # ordering
    "argmin": lambda rs: ([rnd(rs, 3, 5)], {"axis": 1, "keepdims": True},
                          EXACT),
    "argmin/flat": lambda rs: ([rnd(rs, 3, 5)], {}, EXACT),
    "argmax_channel": lambda rs: ([rnd(rs, 3, 5)], {}, EXACT),
    "sort": lambda rs: ([_tied(rs, 4, 9)], {"axis": 1}, EXACT),
    "sort/descending": lambda rs: ([_tied(rs, 4, 9)],
                                   {"axis": 0, "is_ascend": False}, EXACT),
    "argsort": lambda rs: ([_tied(rs, 4, 9)], {"axis": -1}, EXACT),
    "argsort/descending": lambda rs: ([_tied(rs, 4, 9)],
                                      {"is_ascend": False,
                                       "dtype": "int32"}, EXACT),
    "topk": lambda rs: ([_tied(rs, 4, 9)], {"k": 3}, EXACT),
    "topk/value": lambda rs: ([_tied(rs, 4, 9)],
                              {"k": 3, "ret_typ": "value", "axis": 0},
                              EXACT),
    "topk/both_ascend": lambda rs: ([_tied(rs, 4, 9)],
                                    {"k": 4, "ret_typ": "both",
                                     "is_ascend": True}, EXACT),
    "topk/mask": lambda rs: ([_tied(rs, 4, 9)], {"k": 2, "ret_typ": "mask"},
                             EXACT),
    # losses
    "smooth_l1": lambda rs: ([rnd(rs, 4, 5, lo=-2, hi=2)], {"scalar": 1.5},
                             ARITH),
    "softmax_cross_entropy": lambda rs: (
        [rnd(rs, 4, 6, lo=-2, hi=2), ints(rs, 4, hi=6).astype(np.float32)],
        {}, TRANS),
    # shape and index
    "slice": lambda rs: ([rnd(rs, 4, 5, 6)],
                         {"begin": (1, None), "end": (3, 4),
                          "step": (1, 2)}, EXACT),
    "slice/negative_step": lambda rs: ([rnd(rs, 4, 5, 6)],
                                       {"begin": (3, None, 5),
                                        "end": (0, None, None),
                                        "step": (-1, 2, -2)}, EXACT),
    "slice_like": lambda rs: ([rnd(rs, 4, 5, 6), rnd(rs, 2, 3, 6)], {},
                              EXACT),
    "slice_like/axes": lambda rs: ([rnd(rs, 4, 5, 6), rnd(rs, 2, 3, 6)],
                                   {"axes": (1,)}, EXACT),
    "broadcast_axis": lambda rs: ([rnd(rs, 3, 1, 1)],
                                  {"axis": (1, 2), "size": (4, 2)}, EXACT),
    "broadcast_like": lambda rs: ([rnd(rs, 1, 4), rnd(rs, 3, 4)], {}, EXACT),
    "repeat": lambda rs: ([rnd(rs, 3, 4)], {"repeats": 2, "axis": 1}, EXACT),
    "repeat/flat": lambda rs: ([rnd(rs, 3, 4)], {"repeats": 3}, EXACT),
    "flip": lambda rs: ([rnd(rs, 3, 4, 5)], {"axis": 1}, EXACT),
    "flip/axes": lambda rs: ([rnd(rs, 3, 4, 5)], {"axis": (0, 2)}, EXACT),
    "gather_nd": lambda rs: ([rnd(rs, 3, 4, 5),
                              np.array([[0, 2, 1], [1, 3, 0]], np.float32)],
                             {}, EXACT),
    "scatter_nd": lambda rs: ([rnd(rs, 4),
                               np.array([[0, 2, 0, 1], [1, 3, 1, 0]],
                                        np.float32)],
                              {"shape": (3, 4)}, ARITH),
    "_scatter_set_nd": lambda rs: ([rnd(rs, 3, 4), rnd(rs, 3),
                                    np.array([[0, 2, 1], [1, 3, 0]],
                                             np.float32)],
                                   {"shape": (3, 4)}, EXACT),
    "batch_take": lambda rs: ([rnd(rs, 4, 5),
                               np.array([0, 4, 2, 1], np.float32)], {},
                              EXACT),
    "shape_array": lambda rs: ([rnd(rs, 3, 4, 5)], {}, EXACT),
    "size_array": lambda rs: ([rnd(rs, 3, 4, 5)], {}, EXACT),
    "diag": lambda rs: ([rnd(rs, 4, 5)], {"k": 1}, EXACT),
    "diag/vector": lambda rs: ([rnd(rs, 4)], {"k": -1}, EXACT),
    "diag/batched": lambda rs: ([rnd(rs, 2, 4, 4)], {}, EXACT),
    "depth_to_space": lambda rs: ([rnd(rs, 2, 8, 3, 3)], {"block_size": 2},
                                  EXACT),
    "space_to_depth": lambda rs: ([rnd(rs, 2, 2, 6, 4)], {"block_size": 2},
                                  EXACT),
    "SequenceLast": lambda rs: ([rnd(rs, 4, 3, 2)], {}, EXACT),
    "SequenceLast/lengths": lambda rs: (
        [rnd(rs, 4, 3, 2), np.array([2, 4, 1], np.float32)],
        {"use_sequence_length": True}, EXACT),
    "SequenceLast/axis1": lambda rs: (
        [rnd(rs, 3, 4, 2), np.array([2, 4, 1], np.float32)],
        {"use_sequence_length": True, "axis": 1}, EXACT),
    "SequenceReverse": lambda rs: ([rnd(rs, 4, 3, 2)], {}, EXACT),
    "SequenceReverse/lengths": lambda rs: (
        [rnd(rs, 4, 3, 2), np.array([2, 4, 1], np.float32)],
        {"use_sequence_length": True}, EXACT),
    # the reference reverses along axis 0 whatever `axis` says
    "SequenceReverse/axis1": lambda rs: (
        [rnd(rs, 4, 3, 2), np.array([2, 4, 1], np.float32)],
        {"use_sequence_length": True, "axis": 1}, EXACT),
    # assignment
    "_slice_assign": lambda rs: ([rnd(rs, 4, 5), rnd(rs, 2, 2)],
                                 {"begin": (1, 0), "end": (3, 4),
                                  "step": (1, 2)}, EXACT),
    "_slice_assign/negative_step": lambda rs: (
        [rnd(rs, 4, 5), rnd(rs, 2, 3)],
        {"begin": (3, None), "end": (0, None), "step": (-2, 2)}, EXACT),
    "_slice_assign_scalar": lambda rs: ([rnd(rs, 4, 5)],
                                        {"scalar": 2.5, "begin": (None, 1),
                                         "end": (None, -1),
                                         "step": (-1, None)}, EXACT),
    "_scatter_elemwise_div": lambda rs: ([rnd(rs, 3, 4),
                                          signed_away(rs, 3, 4)], {}, TRANS),
    "_scatter_plus_scalar": lambda rs: ([rnd(rs, 3, 4)], {"scalar": 1.5},
                                        ARITH),
    "_scatter_minus_scalar": lambda rs: ([rnd(rs, 3, 4)], {"scalar": 1.5},
                                         ARITH),
    "choose_element_0index": lambda rs: ([rnd(rs, 4, 5),
                                          np.array([0, 4, 2, 9], np.float32)],
                                         {}, EXACT),
    "fill_element_0index": lambda rs: ([rnd(rs, 4, 5), rnd(rs, 4),
                                        np.array([0, 4, 2, 1], np.float32)],
                                       {}, EXACT),
    "_grad_add": lambda rs: ([rnd(rs, 3, 4), rnd(rs, 3, 4)], {}, ARITH),
    "_identity_with_attr_like_rhs": lambda rs: ([rnd(rs, 3, 4),
                                                 rnd(rs, 3, 4)], {}, EXACT),
    "BlockGrad": lambda rs: ([rnd(rs, 3, 4)], {}, EXACT),
})


def _nan_holes(x):
    x = x.copy()
    x.reshape(-1)[::7] = np.nan
    return [x]


def _tied(rs, *shape):
    """Values from a small set, so every row has ties."""
    return rs.randint(-3, 4, shape).astype(np.float32)


#: every name (alias included) that this file ports, -> its case's op
ALIASES = {
    "_crop_assign": "_slice_assign", "_crop_assign_scalar":
    "_slice_assign_scalar", "crop": "slice", "reverse": "flip",
    "broadcast_axes": "broadcast_axis", "ElementWiseSum": "add_n",
    "_sum": "add_n", "_square_sum": "square_sum",
    "_contrib_quadratic": "quadratic", "make_loss_identity": "BlockGrad",
}


ALL_CASES = sorted(CASES) + sorted(ALIASES)


@pytest.mark.parametrize("case", ALL_CASES)
def test_op_parity(case):
    """The case's registered name (before any "/") on its inputs; an
    alias runs its op's case under the alias's own name."""
    name = case.split("/")[0]
    base = case if case in CASES else ALIASES[name]
    arrays, params, tol = CASES[base](np.random.RandomState(
        sum(map(ord, base)) % 1000))
    check_case(name, arrays, params, tol)


def test_every_tensor_name_has_a_case():
    """Every name of the reference's ops/tensor.py is registered in the
    port, and every case here calls a name of the reference's."""
    ref_tensor = {n for n, od in ref_registry.OPS.items()
                  if od.fn.__module__ == "mxnet_tpu.ops.tensor"}
    assert not sorted(ref_tensor - set(port_registry.OPS))
    covered = {c.split("/")[0] for c in CASES} | set(ALIASES)
    assert covered <= set(ref_registry.OPS)


# ---------------------------------------------------------------------------
# named corner cases
# ---------------------------------------------------------------------------


def test_round_half_away_rint_half_even():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, -3.49],
                 np.float32)
    ref, port = check_values("round", [x], {}, EXACT)
    np.testing.assert_array_equal(port[0], [-3, -2, -1, 1, 2, 3, 4, -3])
    ref, port = check_values("rint", [x], {}, EXACT)
    np.testing.assert_array_equal(port[0], [-2, -2, -0, 0, 2, 2, 4, -3])


def test_mod_follows_the_divisor_sign():
    a = np.array([7.0, -7.0, 7.0, -7.0, 5.5], np.float32)
    b = np.array([3.0, 3.0, -3.0, -3.0, -2.0], np.float32)
    _, port = check_values("_mod", [a, b], {}, EXACT)
    np.testing.assert_array_equal(port[0], [1, 2, -2, -1, -0.5])
    _, port = check_values("_mod", [a.astype(np.int32), b.astype(np.int32)],
                           {}, EXACT)
    assert port[0].dtype == np.int32
    np.testing.assert_array_equal(port[0], [1, 2, -2, -1, -1])


def test_gamma_is_the_modulus_at_negative_arguments():
    x = np.array([-0.5, -1.5, -2.5, 0.5, 3.0], np.float32)
    _, port = check_values("gamma", [x], {}, TRANS)
    assert (port[0] > 0).all()


@pytest.mark.parametrize("name,params", [
    ("sort", {"axis": -1}), ("sort", {"is_ascend": False}),
    ("argsort", {}), ("argsort", {"is_ascend": False}),
    ("topk", {"k": 5}), ("topk", {"k": 5, "is_ascend": True}),
    ("topk", {"k": 5, "ret_typ": "both"}),
    ("topk", {"k": 3, "ret_typ": "mask", "axis": 0}),
])
def test_ordering_ties(name, params):
    """All-equal rows and rows of few values: indices exactly the
    reference's (stable sort; a descending order the flip of it; the
    lower index first in topk)."""
    x = np.array([[1, 1, 1, 1, 1, 1, 1], [2, 0, 2, 1, 0, 2, 1],
                  [0, 3, 3, 0, 3, 0, 3]], np.float32)
    check_values(name, [x], params, EXACT)


def test_slice_negative_steps_against_numpy():
    x = np.arange(60, dtype=np.float32).reshape(3, 4, 5)
    for begin, end, step in [((None,), (None,), (-1,)),
                             ((2, 3), (None, 0), (-1, -2)),
                             ((0, -1, 4), (3, None, 0), (2, -1, -3))]:
        got = tmx.nd.slice(tmx.nd.array(x), begin=begin, end=end,
                           step=step).asnumpy()
        want = x[tuple(slice(b, e, s) for b, e, s in zip(begin, end, step))]
        np.testing.assert_array_equal(got, want)
        check_values("slice", [x], dict(begin=begin, end=end, step=step),
                     EXACT)


def test_slice_assign_leaves_lhs_unchanged():
    x = np.zeros((3, 4), np.float32)
    lhs = tmx.nd.array(x)
    out = tmx.nd._slice_assign(lhs, tmx.nd.ones((2, 2)), begin=(0, 0),
                               end=(2, 2))
    np.testing.assert_array_equal(lhs.asnumpy(), x)
    assert out.asnumpy().sum() == 4


def test_scatter_nd_adds_duplicates():
    data = np.array([1.0, 2.0, 4.0], np.float32)
    idx = np.array([[1, 1, 0], [2, 2, 0]], np.float32)
    _, port = check_values("scatter_nd", [data, idx], {"shape": (2, 3)},
                           EXACT)
    assert port[0][1, 2] == 3.0 and port[0][0, 0] == 4.0


def test_matmul_rejects_vectors():
    a = tmx.nd.array(np.ones((3,), np.float32))
    with pytest.raises(TypeError):
        tmx.nd._matmul(a, a)


def test_index_inputs_any_dtype():
    """int32 and float32 index arrays give the same result."""
    x = np.random.RandomState(0).rand(4, 5).astype(np.float32)
    for idx in (np.array([0, 4, 2, 1], np.int32),
                np.array([0, 4, 2, 1], np.float32)):
        check_values("batch_take", [x, idx], {}, EXACT)
        check_values("choose_element_0index", [x, idx], {}, EXACT)


def test_khatri_rao_docstring_example():
    A = np.array([[1, -1], [2, -3]], np.float32)
    B = np.array([[1, 4], [2, 5], [3, 6]], np.float32)
    _, port = check_values("khatri_rao", [A, B], {}, EXACT)
    np.testing.assert_array_equal(port[0], [[1, -4], [2, -5], [3, -6],
                                            [2, -12], [4, -15], [6, -18]])


# ---------------------------------------------------------------------------
# NDArray operators and the nd helpers
# ---------------------------------------------------------------------------

_OPERATORS = {
    "mod": lambda a, b: a % b, "rmod_scalar": lambda a, b: 7.0 % a,
    "mod_scalar": lambda a, b: a % 2.5,
    "and": lambda a, b: a & b, "rand": lambda a, b: 1.0 & a,
    "or": lambda a, b: a | b, "ror_scalar": lambda a, b: 0.0 | a,
    "xor": lambda a, b: a ^ b, "rxor": lambda a, b: 1.0 ^ a,
    "invert": lambda a, b: ~a, "matmul": lambda a, b: a @ b.T,
    "div": lambda a, b: a.__div__(b), "rdiv": lambda a, b: a.__rdiv__(2.0),
}


@pytest.mark.parametrize("op", sorted(_OPERATORS))
def test_ndarray_operator(op):
    rs = np.random.RandomState(1)
    a = rs.choice([0.0, 1.5, -2.0, 3.0], (3, 4)).astype(np.float32)
    b = rs.choice([1.0, -2.5, 4.0], (3, 4)).astype(np.float32)
    fn = _OPERATORS[op]
    ref = fn(mx.nd.array(a), mx.nd.array(b)).asnumpy()
    port = fn(tmx.nd.array(a), tmx.nd.array(b)).asnumpy()
    assert port.dtype == ref.dtype and port.shape == ref.shape
    np.testing.assert_allclose(port, ref, **ARITH)


@pytest.mark.parametrize("method", ["floor", "ceil", "round", "sin", "prod",
                                    "sort", "argsort", "topk", "flip",
                                    "nansum", "square_sum"])
def test_ndarray_methods(method):
    x = np.random.RandomState(2).uniform(-3, 3, (3, 4)).astype(np.float32)
    ref = getattr(mx.nd.array(x), method)().asnumpy()
    port = getattr(tmx.nd.array(x), method)().asnumpy()
    assert port.dtype == ref.dtype
    np.testing.assert_allclose(port, ref, **TRANS)


def test_nd_helpers():
    rs = np.random.RandomState(3)
    x = rs.rand(2, 3, 4).astype(np.float32)
    np.testing.assert_array_equal(
        tmx.nd.moveaxis(tmx.nd.array(x), 0, 2).asnumpy(),
        mx.nd.moveaxis(mx.nd.array(x), 0, 2).asnumpy())
    for arg, kw in [(2, dict(axis=0)), ([1, 3], dict(axis=2)),
                    (3, dict(axis=1, squeeze_axis=True))]:
        ref = mx.nd.split_v2(mx.nd.array(x), arg, **kw)
        port = tmx.nd.split_v2(tmx.nd.array(x), arg, **kw)
        assert len(port) == len(ref)
        for r, p in zip(ref, port):
            np.testing.assert_array_equal(p.asnumpy(), r.asnumpy())
    with pytest.raises(ValueError):
        tmx.nd.split_v2(tmx.nd.array(x), 2, axis=1)
    idx = np.array([1, 0, 3], np.float32)
    ref_out, port_out = mx.nd.zeros((3, 4)), tmx.nd.zeros((3, 4))
    mx.nd.onehot_encode(mx.nd.array(idx), ref_out)
    res = tmx.nd.onehot_encode(tmx.nd.array(idx), port_out)
    assert res is port_out
    np.testing.assert_array_equal(port_out.asnumpy(), ref_out.asnumpy())
    assert tmx.nd.current_context() == tmx.cpu()
