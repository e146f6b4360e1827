"""The port's device mesh without a card (`parallel.mesh`), on the CPU.

`visible_devices()` raises where no CUDA device is visible, so a mesh built
without devices never runs on the CPU where a card was meant; a run of one
rank (`init_distributed("cpu", rank=0, world_size=1)`, which makes no
process group) still builds its mesh on the device `init_distributed`
chose, as the dryrun's and the parallel tests' one-rank runs do.
"""

import pytest
import torch

from mixgantts_tpu_torch.parallel import mesh as mesh_mod


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(mesh_mod, "_RANK_DEVICE", None)


def test_visible_devices_raise_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        mesh_mod.visible_devices()
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        mesh_mod.make_mesh()


def test_one_rank_cpu_mesh_builds_on_the_chosen_device(no_card):
    rank, world, device = mesh_mod.init_distributed("cpu", rank=0, world_size=1)
    assert (rank, world, device.type) == (0, 1, "cpu")
    mesh = mesh_mod.make_mesh(model_axis=1)
    assert mesh.device == torch.device("cpu") and not mesh.multi_process
    assert (mesh.shape["data"], mesh.shape["model"]) == (1, 1)
    # a device list still builds the single-process mesh it names
    assert mesh_mod.make_mesh(["cpu"] * 4, model_axis=2).shape == {"data": 2, "model": 2}
