"""The port's sharding rules and sharding trees (``repro_torch.dist.sharding``,
``repro_torch.launch.steps``) against the reference's on the CPU, with no
ranks: meshes are shapes (the port's ``AbstractMesh``, the reference's
``jax.sharding.AbstractMesh``), and every spec is compared exactly, entry
for entry.

- ``make_rules`` for all 16 combinations of mode x multi_pod x
  context_parallel x zero3, and ``LOGICAL_AXES``;
- ``_spec_for`` for every ``constrain`` tuple in the models, on meshes
  (4, 2), (2, 4, 2), (16, 16) and (2, 16, 16), without and with sizes;
- ``param_shardings`` / ``opt_shardings`` / ``batch_shardings`` /
  ``cache_shardings`` leaf for leaf for all ten archs, smoke and full size
  (the port's trees on ``meta``, the reference's from ``jax.eval_shape``),
  in train and serve modes;
- the models' ``constrain`` names equal the reference's (the shared
  collectors), and the lint's two sharding rules: zero findings on the port,
  one on a planted ``Shard(0)`` and one on a planted undeclared axis.
"""
import ast
import itertools
import pathlib
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh as JMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.analysis.rules import sharding_layers as jlayers  # noqa: E402
from repro.configs.base import smoke_config as jsmoke  # noqa: E402
from repro.dist import sharding as jshd  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.analysis import engine  # noqa: E402
from repro_torch.analysis.rules import get_rule, sharding_layers  # noqa: E402
from repro_torch.configs.base import smoke_config  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.launch import steps  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODELS = ROOT / "src" / "repro_torch" / "models"
JMODELS = ROOT / "src" / "repro" / "models"
COMBOS = list(itertools.product(["train", "serve"], [False, True],
                                [False, True], [False, True]))
MESHES = {(4, 2): ("data", "model"), (2, 4, 2): ("pod", "data", "model"),
          (16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}
SIZES = (1, 2, 4, 6, 8, 12, 16, 20, 32, 64, 96, 128)


def _meshes(shape):
    names = MESHES[shape]
    return shd.AbstractMesh(shape, names), JMesh(shape, names)


def _rules(mode, multi_pod, cp, zero3):
    kw = dict(multi_pod=multi_pod, context_parallel=cp, zero3=zero3)
    return shd.make_rules(mode, **kw), jshd.make_rules(mode, **kw)


def _constrain_tuples(models_dir) -> set:
    """The logical-axes tuple of every ``constrain(x, ...)`` call whose axes
    are literals."""
    out = set()
    for p in sorted(models_dir.glob("*.py")):
        for node in ast.walk(ast.parse(p.read_text())):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", getattr(node.func, "attr",
                                                         None)) == "constrain"
                    and all(isinstance(a, ast.Constant)
                            for a in node.args[1:])):
                out.add(tuple(a.value for a in node.args[1:]))
    return out


# ----------------------------------------------------------------- rule tables

@pytest.mark.parametrize("mode,multi_pod,cp,zero3", COMBOS)
def test_make_rules_equal_the_reference(mode, multi_pod, cp, zero3):
    ours, ref = _rules(mode, multi_pod, cp, zero3)
    assert ours == ref


def test_logical_axes_and_bad_mode_as_the_reference():
    assert shd.LOGICAL_AXES == jshd.LOGICAL_AXES
    with pytest.raises(ValueError):
        shd.make_rules("deploy")


def test_constrain_names_and_tuples_equal_the_reference():
    assert sharding_layers.constrain_axis_names(MODELS) == \
        jlayers.constrain_axis_names(JMODELS)
    assert sharding_layers.rules_get_names(MODELS) == \
        jlayers.rules_get_names(JMODELS)
    assert _constrain_tuples(MODELS) == _constrain_tuples(JMODELS)
    assert sharding_layers.rules_get_names(MODELS) <= set(shd.LOGICAL_AXES)


@pytest.mark.parametrize("mesh_shape", list(MESHES))
def test_spec_for_every_constrain_tuple_equals_the_reference(mesh_shape):
    mesh, jmesh = _meshes(mesh_shape)
    tuples = sorted(_constrain_tuples(MODELS), key=repr)
    n = 0
    for combo in COMBOS:
        rules, jrules = _rules(*combo)
        for names in tuples:
            assert tuple(shd._spec_for(mesh, rules, names)) == \
                tuple(jshd._spec_for(jmesh, jrules, names))
            for k in range(len(SIZES)):
                shape = tuple(SIZES[(k + 3 * i) % len(SIZES)]
                              for i in range(len(names)))
                assert tuple(shd._spec_for(mesh, rules, names, shape)) == \
                    tuple(jshd._spec_for(jmesh, jrules, names, shape))
                n += 1
    assert n == 16 * len(tuples) * len(SIZES)


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = shd.AbstractMesh((2, 4, 2), ("pod", "data", "model"))
    assert shd.placements(mesh, shd.pspec(("pod", "data"), None, "model")) \
        == (Shard(0), Shard(0), Shard(2))
    assert shd.placements(mesh, shd.pspec(None, "data")) == \
        (Replicate(), Shard(1), Replicate())
    assert shd.NamedSharding(mesh, shd.pspec(("pod", "data"), "model")) \
        .placements == (Shard(0), Shard(0), Shard(1))
    # an axis of one rank holds the whole dimension: Replicate
    one = shd.AbstractMesh((1, 2), ("data", "model"))
    assert shd.placements(one, shd.pspec("data", "model")) == \
        (Replicate(), Shard(1))


def test_constrain_is_the_identity_outside_a_context_and_on_a_plain_tensor():
    x = torch.arange(12.0).reshape(3, 4)
    assert shd.constrain(x, "batch", "mlp") is x
    mesh = shd.AbstractMesh((4, 2), ("data", "model"))
    with shd.shard_ctx(mesh, shd.make_rules("train")) as ctx:
        assert shd.current_ctx() == ctx
        assert shd.constrain(x, "batch", "mlp") is x
        with pytest.raises(ValueError, match="logical axes"):
            shd.constrain(x, "batch")
    assert shd.current_ctx() is None


# --------------------------------------------------------------- the trees

def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tuple(tree.spec)}


def _same_tree(ours, ref):
    """The two trees' specs, leaf for leaf; where the reference refuses the
    tree (a mesh axis on two dims: JAX's DuplicateSpecError), the port
    refuses it too."""
    try:
        ref = ref()
    except Exception as e:  # jax's DuplicateSpecError
        assert type(e).__name__ == "DuplicateSpecError", e
        with pytest.raises(ValueError, match="duplicate entries"):
            ours()
        return 1
    a, b = _flat(ours()), _flat(ref)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k], k
    return 0


_JTREES: dict = {}


def _jtrees(arch, smoke, batch, seq):
    key = (arch, smoke)
    if key not in _JTREES:
        cfg = jconfigs.get(arch)
        cfg = jsmoke(cfg) if smoke else cfg
        p, a = jsteps.abstract_params(cfg)
        c, ca = jsteps.abstract_cache(cfg, batch, seq)
        _JTREES[key] = (cfg, p, a, c, ca)
    return _JTREES[key]


@pytest.mark.parametrize("arch", configs.ARCHS)
@pytest.mark.parametrize("smoke", [True, False])
def test_sharding_trees_equal_the_reference(arch, smoke):
    batch, seq = (4, 64) if smoke else (128, 32768)
    jcfg, jp, ja, jc, jca = _jtrees(arch, smoke, batch, seq)
    cfg = configs.get(arch)
    cfg = smoke_config(cfg) if smoke else cfg
    p, a = steps.abstract_params(cfg)
    c, ca = steps.abstract_cache(cfg, batch, seq)
    assert steps.count_params(p) == jsteps.count_params(jp)
    for mesh_shape in ((4, 2), (16, 16), (2, 16, 16)):
        mesh, jmesh = _meshes(mesh_shape)
        mp = "pod" in MESHES[mesh_shape]
        for mode, zero3, cp in (("train", False, False), ("train", True, False),
                                ("serve", False, False), ("serve", False, True)):
            rules, jrules = _rules(mode, mp, cp, zero3)
            refused = 0
            for ours, ref in (
                    (lambda: steps.param_shardings(mesh, rules, a, p),
                     lambda: jsteps.param_shardings(jmesh, jrules, ja, jp)),
                    (lambda: steps.param_shardings(mesh, rules, a),
                     lambda: jsteps.param_shardings(jmesh, jrules, ja)),
                    (lambda: steps.opt_shardings(mesh, rules, a, p),
                     lambda: jsteps.opt_shardings(jmesh, jrules, ja, jp)),
                    (lambda: steps.batch_shardings(cfg, mesh, rules),
                     lambda: jsteps.batch_shardings(jcfg, jmesh, jrules)),
                    (lambda: steps.cache_shardings(mesh, rules, ca, c),
                     lambda: jsteps.cache_shardings(jmesh, jrules, jca, jc))):
                refused += _same_tree(ours, ref)
            # only the split-KV rule on a cache whose kv heads already take
            # "model" is refused
            assert refused <= int(cp)


# ------------------------------------------------------------------ the lint

def _plant(tmp_path, rel, src):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(src))
    return tmp_path


def test_the_port_is_clean_under_the_sharding_rules():
    rules = [get_rule("sharding-spec-layering"),
             get_rule("sharding-axis-declared")]
    assert engine.run_lint(rules=rules).findings == []


def test_a_planted_shard_in_a_model_is_one_finding(tmp_path):
    root = _plant(tmp_path, "src/repro_torch/models/bad.py", """\
        from torch.distributed.tensor import Shard

        def f(x):
            return x
        """)
    found = engine.run_lint([root / "src"], rel_root=root).findings
    assert [f.rule for f in found] == ["sharding-spec-layering"]
    # dist/ and launch/ build placements: exempt
    ok = _plant(tmp_path / "ok", "src/repro_torch/dist/x.py",
                "from torch.distributed.tensor import Shard\n")
    assert engine.run_lint([ok / "src"], rel_root=ok).findings == []


def test_a_planted_undeclared_axis_is_one_finding(tmp_path):
    root = _plant(tmp_path, "src/repro_torch/models/bad.py", """\
        from repro_torch.models.layers import constrain

        def f(x):
            return constrain(x, "batch", "not_an_axis")
        """)
    found = engine.run_lint([root / "src"], rel_root=root).findings
    assert [f.rule for f in found] == ["sharding-axis-declared"]
    assert "not_an_axis" in found[0].message


def test_jax_abstract_meshes_are_what_the_reference_compares():
    # the reference's trees above are NamedShardings on jax AbstractMeshes:
    # no fake devices are made in this process
    assert jax.device_count() == 1
