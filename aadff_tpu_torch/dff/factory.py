"""Lens and dataset factories keyed by the reference YAML schema (the port
of `aadff_tpu/dff/factory.py`)."""
from __future__ import annotations

from ..psfnet.psfnet import PSFNet, ThinLens
from .dataset import FlyingThings3D, Matterport3D, Middlebury, RealWorld


def get_lens(args: dict, device="cuda"):
    """(train lens, test lens) of a run config, at args["res"] and
    args["ks"] on `device`.  A section with `lens: thinlens` gets the ideal
    `ThinLens` of its `foc_len`, `fnum` and `sensor_size` (numbers or
    strings); any other `lens` is a lens JSON, and the section gets a
    `PSFNet` built on it (the port's ray-traced `Lens`, `PSFNet.lens`; the
    file's path is `PSFNet.lens_path`) with the weights of its
    `psfnet_path`.
    """
    sensor_res = tuple(args["res"])

    def build(section):
        name = args[section]["lens"]
        if name == "thinlens":
            sec = args[section]
            return ThinLens(foc_len=float(sec["foc_len"]), fnum=float(sec["fnum"]),
                            kernel_size=args["ks"],
                            sensor_size=[float(i) for i in sec["sensor_size"]],
                            sensor_res=sensor_res, device=device)
        lens = PSFNet(kernel_size=args["ks"], sensor_res=sensor_res,
                      device=device, filename=name)
        lens.load_net(args[section]["psfnet_path"])
        return lens

    return build("train"), build("test")


def get_dataset(args: dict):
    """(train set, test set) of a run config, by the names of the JAX
    package's factory."""
    train_name = args["train"]["dataset"]
    if train_name == "Matterport3D":
        train_set = Matterport3D(args["train_aif_dir"], args["train_depth_dir"],
                                 resize=args["res"])
    elif train_name == "FlyingThings3D":
        train_set = FlyingThings3D(args["FlyingThings3D_train"], resize=args["res"])
    elif train_name == "SynthMiddlebury":
        # procedural textures over Middlebury depth maps; augmentation on
        train_set = Middlebury(args["SynthMiddlebury_train"], resize=args["res"],
                               train=True)
    else:
        raise NotImplementedError(train_name)

    test_name = args["test"]["dataset"]
    if test_name == "Middlebury2014":
        test_set = Middlebury(args["Middlebury2014_val"], resize=args["res"], train=False)
    elif test_name == "Middlebury2021":
        test_set = Middlebury(args["Middlebury2021_val"], resize=args["res"], train=False)
    elif test_name == "RealWorld":
        test_set = RealWorld(args["RealWorld_val"], resize=args["res"], depth=False)
    elif test_name == "SynthMiddlebury":
        test_set = Middlebury(args["SynthMiddlebury_val"], resize=args["res"],
                              train=False)
    else:
        raise NotImplementedError(test_name)
    return train_set, test_set
