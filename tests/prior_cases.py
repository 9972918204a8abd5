"""Seeded tiny prior nets for the port's tests: each net of the port with a
random state dict, and the same weights as the JAX package's flax params
(through its convert_state_dict). Shared by test_torch_prior_nets.py and
test_torch_priors.py."""
from fusionsense_tpu.priors.depth_anything import convert as JAC
from fusionsense_tpu.priors.depth_anything import dpt as JA
from fusionsense_tpu.priors.dsine import convert as JDC
from fusionsense_tpu.priors.dsine import model as JD
from fusionsense_tpu.priors.metric3d import convert as JMC
from fusionsense_tpu.priors.metric3d import model as JM
from fusionsense_tpu_torch.priors import weights as W
from fusionsense_tpu_torch.priors.depth_anything import dpt as TA
from fusionsense_tpu_torch.priors.dsine import model as TD
from fusionsense_tpu_torch.priors.metric3d import model as TM


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def positive_depth_head(sd):
    """Depth-Anything's head ends in two ReLUs: lift their biases so the
    random net's relative inverse depth is not all zero."""
    sd["depth_head.scratch.output_conv2.0.bias"] += 0.5
    sd["depth_head.scratch.output_conv2.2.bias"] += 0.5
    return sd


def build(name):
    """(port net, its state dict, flax params, port cfg, jax cfg)."""
    if name == "dsine":
        cfg, jcfg = TD.tiny_dsine(), JD.tiny_dsine()
        net = TD.DSINE(cfg)
        sd = W.random_state_dict(net, seed=0, std=0.1)
        params = JDC.convert_state_dict(_np(sd), jcfg)
    elif name == "da":
        cfg, jcfg = TA.tiny_da(), JA.tiny_da()
        net = TA.DepthAnything(cfg)
        sd = positive_depth_head(W.random_state_dict(net, seed=1))
        params, report = JAC.convert_state_dict(_np(sd), jcfg)
        assert not report["missing"] and not report["unused"], report
    else:
        cfg, jcfg = TM.tiny_m3d(), JM.tiny_m3d()
        net = TM.Metric3D(cfg)
        sd = W.random_state_dict(net, seed=2)
        params = JMC.convert_state_dict(_np(sd), jcfg)
    net.load_state_dict(sd)
    return net.eval(), sd, params, cfg, jcfg
