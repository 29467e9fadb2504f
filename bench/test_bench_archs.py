"""Each model family lives in files of its own (``bench/archs/<model_type>.py``
and ``bench/reference/<model_type>.py``), and the generic files name no
family.  The golden values were read before the families moved into
those files: at the families' ``TINY`` sizes and seed ``SEED`` the draw of
every leaf, the tokens and the reference's three losses (f32 and the fp8
control), and at full size the FLOPs of a 2048-token training sequence,
are what they were, to the last digit."""
import math
from pathlib import Path

import pytest
import torch

from bench import cells, harness, inputs, yardstick
from bench.archs import INTERFACE, arch_of
from bench.reference import train as reference
from bench.tiny import tiny_cell

BENCH = Path(__file__).resolve().parent
ARCHS = sorted(p.stem for p in (BENCH / "archs").glob("*.py")
               if not p.name.startswith("_"))
CONFIGS = sorted((BENCH / "configs").glob("*.json"))
GENERIC = ("harness.py", "inputs.py", "runner.py", "yardstick.py", "tiny.py",
           "calibrate.py", "reference/train.py")
FAMILY_WORDS = ("kv_lora_rank", "n_routed_experts", "deepseek_v2", '"olmo"')
SEED = 2 ** 31 + 29
FLOPS_2048 = {"olmo-1b": 15_285_117_517_824,
              "deepseek-v2-lite": 4_722_379_456_512}

GOLDEN = {
    "olmo": {
        "cell": "olmo1b-adpsgd-1gpu",
        "tokens": (264287, 45282303),
        "losses": {
            "f32": [5.561144232749939, 5.555530905723572, 5.551438093185425],
            "fp8": [5.558897614479065, 5.555818200111389, 5.5527448654174805],
        },
        "leaves": [
            ("/blocks/0/attn/wk/w", -7.127004138297707, 410.4867367441657),
            ("/blocks/0/attn/wo/w", 12.901789904291945, 408.5226536226219),
            ("/blocks/0/attn/wq/w", -4.26287018174844, 411.2273824847762),
            ("/blocks/0/attn/wv/w", -2.0079493611337966, 406.6783226076732),
            ("/blocks/0/mlp/w_down/w", 5.08092900132533, 579.6033642616044),
            ("/blocks/0/mlp/w_gate/w", -12.290745278502072, 827.4030395798509),
            ("/blocks/0/mlp/w_up/w", -1.7281057452057667, 822.8790360190908),
            ("/blocks/1/attn/wk/w", 4.33796343650647, 409.33716953377916),
            ("/blocks/1/attn/wo/w", 7.399689713067346, 412.39889309183854),
            ("/blocks/1/attn/wq/w", 4.65183477328776, 411.16267172518076),
            ("/blocks/1/attn/wv/w", -8.535439881932689, 410.3940063904447),
            ("/blocks/1/mlp/w_down/w", -5.440451021222543, 574.6249054809932),
            ("/blocks/1/mlp/w_gate/w", -3.2254349452575752, 818.238794275034),
            ("/blocks/1/mlp/w_up/w", 0.802153929520955, 814.5663544036256),
            ("/embed", 2.006490718512822, 262.1196486810658),
        ],
    },
    "deepseek_v2": {
        "cell": "dsv2lite-adpsgd-1gpu",
        "tokens": (264287, 45282303),
        "losses": {
            "f32": [6.165376543998718, 6.129900932312012, 5.962859153747559],
            "fp8": [6.170365571975708, 6.144629001617432, 5.9615806341171265],
        },
        "leaves": [
            ("/blocks/0/attn/kv_norm/scale", 32.0, 32.0),
            ("/blocks/0/attn/wkv_a/w", 7.248424050178073, 256.7143189131639),
            ("/blocks/0/attn/wkv_b/w", -7.7523968445457285, 576.2211997670674),
            ("/blocks/0/attn/wo/w", 10.442529536256188, 411.0081811872915),
            ("/blocks/0/attn/wq/w", -13.489384811593482, 615.2860057114267),
            ("/blocks/0/mlp/w_down/w", 5.079712201980328, 501.23006905402053),
            ("/blocks/0/mlp/w_gate/w", -4.833619881841514, 618.0936654210454),
            ("/blocks/0/mlp/w_up/w", -9.581891740377614, 621.6321502871469),
            ("/blocks/0/norm1/scale", 64.0, 64.0),
            ("/blocks/0/norm2/scale", 64.0, 64.0),
            ("/blocks/1/attn/kv_norm/scale", 32.0, 32.0),
            ("/blocks/1/attn/wkv_a/w", 8.888432780906442, 256.0372354261417),
            ("/blocks/1/attn/wkv_b/w", -6.535213090610341, 581.4318530335004),
            ("/blocks/1/attn/wo/w", -2.561295672772758, 408.78153846143505),
            ("/blocks/1/attn/wq/w", 3.568948236208712, 612.2525508112004),
            ("/blocks/1/moe/router", -4.366327775060199, 53.731023325934075),
            ("/blocks/1/moe/shared/w_down/w",
             3.0942297577530553, 289.6504437962976),
            ("/blocks/1/moe/shared/w_gate/w",
             -5.7220552565850085, 207.95837399137963),
            ("/blocks/1/moe/shared/w_up/w",
             -5.277191079010663, 200.5301780129157),
            ("/blocks/1/moe/w_down", 6.294221344361631, 2296.3165958140394),
            ("/blocks/1/moe/w_gate", 2.6987487572816917, 1645.2142805296928),
            ("/blocks/1/moe/w_up", 5.947266040369186, 1623.7878698907605),
            ("/blocks/1/norm1/scale", 64.0, 64.0),
            ("/blocks/1/norm2/scale", 64.0, 64.0),
            ("/embed", 2.006490718512822, 262.1196486810658),
            ("/final_norm/scale", 64.0, 64.0),
            ("/lm_head", 27.7526979858485, 1636.9875376467207),
        ],
    },
}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(family):
    cell = tiny_cell(GOLDEN[family]["cell"])
    cfg, t = cell.config, cell.traffic
    params = inputs.make_params(cfg, SEED, "cpu")
    tokens = inputs.make_tokens(cfg["vocab_size"], t["data_steps"],
                                t["replicas"], t["batch"], t["seq"], SEED,
                                "cpu")
    return cell, params, tokens


@pytest.mark.parametrize("family", sorted(GOLDEN))
def test_draw_is_unchanged(family):
    """Every leaf's sum and sum of absolute values (exactly rounded), in
    the tree's order, and the tokens' sum and sum of squares."""
    _, params, tokens = _inputs(family)
    got = [(path, math.fsum(x.flatten().double().tolist()),
            math.fsum(x.flatten().double().abs().tolist()))
           for path, x in zip(reference.leaf_paths(params),
                              reference.leaves(params))]
    assert got == GOLDEN[family]["leaves"]
    t = tokens.long()
    assert (int(t.sum()), int(t.square().sum())) == GOLDEN[family]["tokens"]


@pytest.mark.parametrize("precision", ["f32", "fp8"])
@pytest.mark.parametrize("family", sorted(GOLDEN))
def test_reference_losses_are_unchanged(family, precision, one_thread):
    cell, params, tokens = _inputs(family)
    host = reference.leaves(params)
    skel = reference.rebuild(params, [torch.empty(0, device="meta")
                                      for _ in host])
    out = reference.follow(cell.config, cell.traffic, skel, host, tokens,
                           SEED % harness.ENGINE_SEED_MOD,
                           precision=precision)
    assert out["losses"] == GOLDEN[family]["losses"][precision]


@pytest.mark.parametrize("config", sorted(FLOPS_2048))
def test_flops_per_sequence_are_unchanged(config):
    cfg = cells.load_json("configs", config)
    assert yardstick.train_flops_per_sequence(cfg, 2048) \
        == FLOPS_2048[config]


@pytest.mark.parametrize("name", ARCHS)
def test_family_provides_the_interface(name):
    """A family module has every part of the interface, and a reference
    module beside it."""
    arch = arch_of({"model_type": name})
    for part in INTERFACE:
        assert hasattr(arch, part), f"bench/archs/{name}.py lacks {part}"
    for part in INTERFACE[:-1]:
        assert callable(getattr(arch, part))
    assert isinstance(arch.TINY, dict)
    ref = reference.family_ref({"model_type": name})
    assert callable(getattr(ref, "loss", None))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_every_config_has_a_family(path):
    cfg = cells.load_json("configs", path.stem)
    assert cfg["model_type"] in ARCHS
    assert (BENCH / "reference" / f"{cfg['model_type']}.py").exists()


def test_unknown_family_names_the_files():
    cfg = {"model_type": "no_such_family"}
    with pytest.raises(ModuleNotFoundError,
                       match="add bench/archs/no_such_family.py"):
        arch_of(cfg)
    with pytest.raises(ModuleNotFoundError,
                       match="add bench/reference/no_such_family.py"):
        reference.family_ref(cfg)


@pytest.mark.parametrize("name", GENERIC)
def test_generic_file_names_no_family(name):
    text = (BENCH / name).read_text()
    assert not [w for w in FAMILY_WORDS if w in text]
