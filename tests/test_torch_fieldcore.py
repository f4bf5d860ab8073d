"""The field core's carry chains (`tpu_msm_torch/csrc/bn254.cuh`) on the CPU.

The CUDA core runs on the PTX carry flag, which no CPU test can execute. So
this file reads every asm statement of bn254.cuh, with its operand list, and
runs it instruction by instruction on a Python model of the flag (`Chain`):
`mad.lo.cc`, `madc.hi`, `add.cc`, `subc` and the rest, on 32-bit words.
The glue between the statements (which words feed which chain, row by row)
is written out below as the header writes it: `mont_mul_model` is
`fp_mont_mul`, `add_model` and `sub_model` are `fp_add` and `fp_sub`.

Held here, with hypothesis and on the edge values a in {0, 1, P - 1,
2^256 - 1}, b in {0, 1, P - 1}:
- the model of the product equals a·b·2^-256 mod P (Python ints) and the
  plain field's `field.mont_mul`, for a < 2^256 and b < P;
- every carry that a chain drops (the last instruction of `add8` in the
  product and in `fp_add`, of `mac_odd` and of `mac_odd_shift`) is 0, and
  every word stays within the bounds
  the header's comment states (E < 2^288 with its ninth word <= 2^31, O
  below 2^256, the running value below b + P between rows);
- no carry crosses from one asm statement to the next: each statement's
  first instruction sets the flag without reading it, its last reads it
  without setting it.

A wrong word in a chain would show on the card only as a rare wrong bit;
here it fails on the inputs that carry through it.
"""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import example, given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from tpu_msm_torch.models import bn254  # noqa: E402
from tpu_msm_torch.ops import field  # noqa: E402
from tpu_msm_torch.utils import interop  # noqa: E402

P, R = bn254.P, bn254.R
M32 = 0xFFFFFFFF
P_WORDS = [(P >> (32 * k)) & M32 for k in range(8)]
R_INV = pow(R, -1, P)
CUH = (Path(__file__).resolve().parents[1] / "tpu_msm_torch" / "csrc"
       / "bn254.cuh")


def words(v):
    return [(v >> (32 * k)) & M32 for k in range(8)]


def value(ws):
    return sum(w << (32 * k) for k, w in enumerate(ws))


# --------------------------------------------------------------------------
# The asm statements of bn254.cuh and a model of the PTX carry flag.
# --------------------------------------------------------------------------

_FUNC = re.compile(r"__device__ __forceinline__ [\w&]+ (\w+)\(")
_ASM = re.compile(r"\basm\((.*?)\);", re.S)
_OPERAND = re.compile(r'"([+=]?)r"\(([^)]*)\)')
_EXPR = re.compile(r"^(\w+)(\.w)?(?:\[(\d+)\])?$")


def _asm_statements():
    """{function: (instructions, operands)} of the one asm statement of each
    function that has one: each instruction (mnemonic, [operand tokens]),
    each operand (mode, C expression), numbered %0, %1, ... in the order
    the C lists them."""
    src = CUH.read_text()
    funcs = [(m.start(), m.group(1)) for m in _FUNC.finditer(src)]
    out = {}
    for m in _ASM.finditer(src):
        name = [f for pos, f in funcs if pos < m.start()][-1]
        body = m.group(1)
        template = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"',
                                      body.split(":", 1)[0]))
        lines = [ln.strip() for ln in
                 template.replace("\\n", "\n").replace("\\t", "").split(";")
                 if ln.strip()]
        insns = []
        for ln in lines:
            op, args = ln.split(None, 1)
            insns.append((op, [a.strip() for a in args.split(",")]))
        operands = _OPERAND.findall(body.split(":", 1)[1])
        assert name not in out, f"{name} holds two asm statements"
        out[name] = (insns, operands)
    return out


ASM = _asm_statements()


class Chain:
    """One asm statement on a model of the carry flag. `wraps=True` lets
    its last add drop a carry (add8 in fp_sub's add-back of P); otherwise a
    dropped carry raises, as a broken bound would."""

    def __init__(self, func, wraps=False):
        self.insns, self.operands = ASM[func]
        self.name = func
        self.wraps = wraps

    @staticmethod
    def _ref(expr):
        m = _EXPR.match(expr.strip())
        if not m:
            raise ValueError(f"operand expression {expr!r}")
        return m.groups()

    def _get(self, env, expr):
        name, w, idx = self._ref(expr)
        v = env[name]
        if w:
            v = v.w
        return v if idx is None else v[int(idx)]

    def _set(self, env, expr, val):
        name, w, idx = self._ref(expr)
        if idx is None:
            env[name] = val
            return
        target = env[name].w if w else env[name]
        target[int(idx)] = val

    def __call__(self, env):
        regs = []
        for mode, expr in self.operands:
            regs.append(None if mode == "=" else self._get(env, expr))
        for reg in regs:
            assert reg is None or 0 <= reg <= M32, (self.name, regs)
        cf = None  # no carry enters a statement
        for op, args in self.insns:
            parts = op.split(".")
            base, cc = parts[0], "cc" in parts

            def val(tok):
                if tok.startswith("%"):
                    v = regs[int(tok[1:])]
                    assert v is not None, f"{self.name}: {tok} read unset"
                    return v
                return int(tok, 0)

            if base in ("addc", "subc", "madc"):
                assert cf is not None, f"{self.name}: {op} reads no carry"
                cin = cf
            else:
                cin = 0
            src = [val(t) for t in args[1:]]
            if base in ("add", "addc"):
                t = src[0] + src[1] + cin
            elif base in ("sub", "subc"):
                t = src[0] - src[1] - cin
            elif base in ("mad", "madc"):
                prod = src[0] * src[1]
                half = prod & M32 if "lo" in parts else prod >> 32
                t = half + src[2] + cin
            else:
                raise AssertionError(f"{self.name}: unmodelled {op}")
            if cc:
                cf = int(t > M32 or t < 0)
            else:
                # The chain ends here. A subtraction's borrow is its result
                # (subc d, 0, 0 makes the mask); an add's carry is dropped.
                if base not in ("sub", "subc") and not self.wraps:
                    assert t <= M32, f"{self.name}: {op} drops a carry"
                cf = None
            regs[int(args[0][1:])] = t & M32
        assert cf is None, f"{self.name}: a carry leaves the statement"
        for (mode, expr), reg in zip(self.operands, regs):
            if mode:
                self._set(env, expr, reg)
        return env


def fp(v):
    return SimpleNamespace(w=words(v))


def sub8(d, b_words):
    """d.w -= b (in place); the borrow mask."""
    env = Chain("sub8")({"d": d, "b": SimpleNamespace(w=list(b_words)),
                         "borrow": None})
    return env["borrow"]


def add8(s, b_words, wraps=False):
    """s.w += b (in place)."""
    Chain("add8", wraps=wraps)({"s": s, "b": SimpleNamespace(w=list(b_words))})


def fp_cond_sub_p(t_words):
    d = SimpleNamespace(w=list(t_words))
    return list(t_words) if sub8(d, P_WORDS) else d.w


def add_model(a, b):
    """fp_add: add8, then fp_cond_sub_p."""
    s = fp(a)
    add8(s, words(b))
    return value(fp_cond_sub_p(s.w))


def sub_model(a, b):
    """fp_sub: sub8, then P masked by the borrow added back by add8, whose
    carry out is dropped on purpose (the add wraps exactly when a < b)."""
    d = fp(a)
    borrow = sub8(d, words(b))
    add8(d, [p & borrow for p in P_WORDS], wraps=True)
    return value(d.w)


def mac_even(e, x, w0, w2, w4, w6):
    Chain("mac_even")({"e": e, "x": x, "w0": w0, "w2": w2, "w4": w4,
                       "w6": w6})


def mac_odd(o, x, w1, w3, w5, w7):
    Chain("mac_odd")({"o": o, "x": x, "w1": w1, "w3": w3, "w5": w5,
                      "w7": w7})


def mac_odd_shift(o, e0, e1, x, b_words):
    env = Chain("mac_odd_shift")({"o": o, "e0": e0, "e1": e1, "x": x,
                                  "b": SimpleNamespace(w=b_words)})
    return env["e0"]


def redc_row(e, o):
    m = (e[0] * bn254.P_INV_NEG_32) & M32
    mac_even(e, m, P_WORDS[0], P_WORDS[2], P_WORDS[4], P_WORDS[6])
    mac_odd(o, m, P_WORDS[1], P_WORDS[3], P_WORDS[5], P_WORDS[7])


def _check_row(e, o, a, b, i):
    """The bounds of the header's comment after row i's reduction."""
    assert e[0] == 0
    assert value(e) < 1 << 288 and e[8] <= 1 << 31
    assert value(o) < 1 << 256
    t = (value(e) >> 32) + value(o)  # T after the row's shift
    assert t < b + P
    # T·2^(32(i+1)) == (a mod 2^(32(i+1)))·b (mod P): the CIOS invariant.
    assert (t << (32 * (i + 1))) % P == (a % (1 << (32 * (i + 1)))) * b % P


def mont_mul_model(a, b):
    """fp_mont_mul on the model, statement for statement."""
    aw, bw = words(a), words(b)
    e, o = [0] * 9, [0] * 8
    for j in range(0, 8, 2):  # row 0: products on zero words, no carries
        e[j], e[j + 1] = (aw[0] * bw[j]) & M32, (aw[0] * bw[j]) >> 32
        o[j], o[j + 1] = (aw[0] * bw[j + 1]) & M32, (aw[0] * bw[j + 1]) >> 32
    redc_row(e, o)
    _check_row(e, o, a, b, 0)
    for i in range(1, 8):
        ne, no = [0] * 9, e[2:9] + [0]
        ne[0] = mac_odd_shift(no, o[0], e[1], aw[i], bw)
        ne[1:8] = o[1:8]
        mac_even(ne, aw[i], bw[0], bw[2], bw[4], bw[6])
        redc_row(ne, no)
        e, o = ne, no
        _check_row(e, o, a, b, i)
    r = SimpleNamespace(w=e[1:9])
    add8(r, o)
    assert value(r.w) < 2 * P
    return value(fp_cond_sub_p(r.w))


# --------------------------------------------------------------------------
# Tests.
# --------------------------------------------------------------------------

A_EDGES = [0, 1, P - 1, R - 1]
B_EDGES = [0, 1, P - 1]
# Words that make carries: all ones, the top bit alone, and their neighbours.
_WORD = st.one_of(st.sampled_from([0, 1, 0x7FFFFFFF, 0x80000000,
                                   0xFFFFFFFE, M32]),
                  st.integers(0, M32))
_BY_WORDS = st.lists(_WORD, min_size=8, max_size=8).map(value)
A_VALUES = st.one_of(st.sampled_from(A_EDGES), st.integers(0, R - 1),
                     _BY_WORDS)
B_VALUES = st.one_of(st.sampled_from(B_EDGES), st.integers(0, P - 1),
                     _BY_WORDS.map(lambda v: v % P))
F_VALUES = st.one_of(st.sampled_from([0, 1, P - 2, P - 1]),
                     st.integers(0, P - 1), _BY_WORDS.map(lambda v: v % P))


def test_every_chain_is_one_whole_asm_statement():
    """Each asm statement starts without reading the carry flag and ends
    without setting it, and the model knows every instruction in it."""
    assert set(ASM) == {"sub8", "add8", "mac_even", "mac_odd",
                        "mac_odd_shift"}
    for func, (insns, operands) in ASM.items():
        first, last = insns[0][0], insns[-1][0]
        assert not first.startswith(("addc", "subc", "madc")), func
        assert ".cc" not in last, func
        assert all(".cc" in op for op, _ in insns[:-1]), func
        for op, _ in insns:
            assert op.split(".")[0] in ("add", "addc", "sub", "subc", "mad",
                                        "madc"), (func, op)
        assert all(mode in ("+", "=", "") for mode, _ in operands)


@pytest.mark.parametrize("a", A_EDGES)
@pytest.mark.parametrize("b", B_EDGES)
def test_mont_mul_model_on_edges(a, b):
    assert mont_mul_model(a, b) == a * b * R_INV % P


@settings(max_examples=300, deadline=None)
@given(a=A_VALUES, b=B_VALUES)
@example(a=R - 1, b=P - 1)
@example(a=P, b=P - 1)
def test_mont_mul_model_matches_ints(a, b):
    assert mont_mul_model(a, b) == a * b * R_INV % P


def test_mont_mul_model_matches_plain_field():
    """The model against field.mont_mul (the plain versions' core) on the
    edge pairs and seeded values, a up to 2^256 - 1."""
    rng = np.random.RandomState(81)
    pairs = [(a, b) for a in A_EDGES for b in B_EDGES]
    pairs += [(int.from_bytes(rng.bytes(32), "little"),
               int.from_bytes(rng.bytes(32), "little") % P)
              for _ in range(40)]
    a, b = zip(*pairs)

    def t(vs):
        return torch.from_numpy(interop.ints_to_limbs(list(vs)).view(np.int32))

    got = interop.limbs_to_ints(field.mont_mul(t(a), t(b)).numpy()
                                .view(np.uint32))
    assert got == [mont_mul_model(x, y) for x, y in pairs]


@settings(max_examples=300, deadline=None)
@given(a=F_VALUES, b=F_VALUES)
@example(a=P - 1, b=P - 1)
@example(a=0, b=P - 1)
def test_add_and_sub_models_match_ints(a, b):
    assert add_model(a, b) == (a + b) % P
    assert sub_model(a, b) == (a - b) % P


def test_add_and_sub_models_match_plain_field():
    vals = [0, 1, P - 2, P - 1, P // 2, (P + 1) // 2]
    pairs = [(a, b) for a in vals for b in vals]
    a, b = zip(*pairs)

    def t(vs):
        return torch.from_numpy(interop.ints_to_limbs(list(vs)).view(np.int32))

    def ints(x):
        return interop.limbs_to_ints(x.numpy().view(np.uint32))

    assert ints(field.add_mod(t(a), t(b))) == [add_model(*p) for p in pairs]
    assert ints(field.sub_mod(t(a), t(b))) == [sub_model(*p) for p in pairs]


def test_a_dropped_carry_fails_the_model():
    """The check behind the bounds: mac_odd's last carry is dropped, and an
    accumulator at 2^256 - 1 makes it 1, which the model refuses."""
    o = [M32] * 8
    with pytest.raises(AssertionError, match="drops a carry"):
        mac_odd(o, M32, M32, M32, M32, M32)
