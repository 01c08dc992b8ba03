"""The heightfield scene kind gives, bit for bit, what the harness gave
before scene kinds: for both configurations at four seeds, the input
arrays, the asset files and the program's SceneConfig of each of their
cells, and in the tiny cells the reference's values at the sampled
pixels on the CPU.

The digests were taken on the commit before scene kinds, from
scenegen.make_inputs, scenegen.write_assets, run.scene_config and
verify.reference_values over reference.scene.build. The arrays come
from float32 sines and the reference's values from float32 PyTorch on
the CPU, so a NumPy or PyTorch that rounds those differently reads other
digests: recompute them on that commit then.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import pytest
import torch

from rtbench import harness, traffic, verify
from rtbench.tests import tiny

# the last seed is past 2**32, where the program takes the seed's low
# 32 bits
SEEDS = (7, 2147483904, 3000000011, 8589934597)
CELLS = {"refscene-terrain91": ("refscene-terrain91.orbit-1080p",
                                "refscene-terrain91.pt4-1080p"),
         "terrain512-bvh": ("terrain512-bvh.orbit-1080p",
                            "terrain512-bvh.pt3-540p")}
ARRAYS = ("positions", "uvs", "normals", "faces", "texture_u8")
ASSET_FILES = ("mesh.obj", "mesh.mtl", "albedo.png")
# presenting steps checked in the tiny cells: lit frames across the
# orbit; path-traced frames of four accumulations, from one to three
# samples
STEPS = {tiny.TINY_ORBIT: (3, 4, 17, 60), tiny.TINY_PT: (3, 4, 5, 9, 10)}

# SceneInputs: each array (dtype, shape and bytes); "rest": repr of the
# spheres, transform, light and material
INPUTS = {
    "refscene-terrain91/7": {
        "positions":
            "3830572c186b1797591cad54460f79ad97376d9793199cd9681f9be707fb0271",
        "uvs":
            "3234ac4c0c99c23c931dbe381c36df4c792cd6f9690641b2b15539d96d41c2db",
        "normals":
            "fe24e4f4d33e06352f453ac8b6964212a72924c1436f5b3bc3c998cec5f0e7f8",
        "faces":
            "fc165301bcb48428e64cb406ee58d1098ed6952781c0075dbf9ccea3d420120c",
        "texture_u8":
            "30b26c95bd854730b770881e3b278f0e9e2ca18a48140e1309d62d3f2b2d1fd1",
        "rest":
            "b1908f49763d6dd549f8b7236e970c35becc64c2be46db4e6ea390304e08ea46",
    },
    "refscene-terrain91/2147483904": {
        "positions":
            "b1d85a4b1bea981555d7a12a134f73eab0c79102c7c928a92159fb76d8f61611",
        "uvs":
            "3234ac4c0c99c23c931dbe381c36df4c792cd6f9690641b2b15539d96d41c2db",
        "normals":
            "4f8b73fc8f20813e4a806ae9812e2eaa11ee7bad5584b4e626ea2e9c393a8238",
        "faces":
            "fc165301bcb48428e64cb406ee58d1098ed6952781c0075dbf9ccea3d420120c",
        "texture_u8":
            "14df45ad314d2d82ce42f90d0ebb662c5db181724c6382aed70955bf6fa51556",
        "rest":
            "b1908f49763d6dd549f8b7236e970c35becc64c2be46db4e6ea390304e08ea46",
    },
    "refscene-terrain91/3000000011": {
        "positions":
            "10fa1b213873a3d9f1071c6f0e28855a8568d213e339719c18bbd001394d9f0a",
        "uvs":
            "3234ac4c0c99c23c931dbe381c36df4c792cd6f9690641b2b15539d96d41c2db",
        "normals":
            "b2619f14545ca27854438c91c0575441e5263e1013cf5d064c18c6cacc30f1d8",
        "faces":
            "fc165301bcb48428e64cb406ee58d1098ed6952781c0075dbf9ccea3d420120c",
        "texture_u8":
            "a35d07d4b20b787a057f2f11091d88987080f7f215170f874e017b44373c86de",
        "rest":
            "b1908f49763d6dd549f8b7236e970c35becc64c2be46db4e6ea390304e08ea46",
    },
    "refscene-terrain91/8589934597": {
        "positions":
            "e03dc440b8f2f4a0d34a7f3ca1e1b028b1943e9ff245fd9956bf42247cedfbe8",
        "uvs":
            "3234ac4c0c99c23c931dbe381c36df4c792cd6f9690641b2b15539d96d41c2db",
        "normals":
            "a8336e6685199aef62d5a5ad14e98e52daf3202bb6fc69c5b13626841f22f27e",
        "faces":
            "fc165301bcb48428e64cb406ee58d1098ed6952781c0075dbf9ccea3d420120c",
        "texture_u8":
            "03dec0c25e2a3183d85e32ff6c8cbb0e3b716df7f78dd28c564e6f02e383150a",
        "rest":
            "b1908f49763d6dd549f8b7236e970c35becc64c2be46db4e6ea390304e08ea46",
    },
    "terrain512-bvh/7": {
        "positions":
            "8e20de244fd5a407b5d71d2b7a1d8e992b8cf46dcc363d4f9dc90123278b01a1",
        "uvs":
            "dbc2cab195fb2f105fe638b581db72069dad56f7d254954a29c60b9a7e7ec66e",
        "normals":
            "926174bc87d1afb26e524ee884c32c4e0db92635a0774f4ae8c9192af0e6a8be",
        "faces":
            "245ec915e5cba6d086c4d669153f91bd79b9a0e0cd6f6b7cccd51e04d55ecfa4",
        "texture_u8":
            "30b26c95bd854730b770881e3b278f0e9e2ca18a48140e1309d62d3f2b2d1fd1",
        "rest":
            "6ffcb6dd376d3ccc329aace41b4d0b43e33d959d4d812f06332127967426c844",
    },
    "terrain512-bvh/2147483904": {
        "positions":
            "258ea7cb7444e9e7103f1baa7109d547491f1260b0c29dc08831a9cc0253d68c",
        "uvs":
            "dbc2cab195fb2f105fe638b581db72069dad56f7d254954a29c60b9a7e7ec66e",
        "normals":
            "381eefd1bc0e8f78eaf4e35030d997a2fc3def31ebe3d3d639b71c1155846eaa",
        "faces":
            "245ec915e5cba6d086c4d669153f91bd79b9a0e0cd6f6b7cccd51e04d55ecfa4",
        "texture_u8":
            "14df45ad314d2d82ce42f90d0ebb662c5db181724c6382aed70955bf6fa51556",
        "rest":
            "6ffcb6dd376d3ccc329aace41b4d0b43e33d959d4d812f06332127967426c844",
    },
    "terrain512-bvh/3000000011": {
        "positions":
            "76f14a3685117f0dcdd6ece00d79d5efcd2ff1ddd8cb85dbd304bbaaca6f97f5",
        "uvs":
            "dbc2cab195fb2f105fe638b581db72069dad56f7d254954a29c60b9a7e7ec66e",
        "normals":
            "efa2a736d6c0bc6cced11c04a63f00e1c8b18a5b18733e5ff466935480ce4cfa",
        "faces":
            "245ec915e5cba6d086c4d669153f91bd79b9a0e0cd6f6b7cccd51e04d55ecfa4",
        "texture_u8":
            "a35d07d4b20b787a057f2f11091d88987080f7f215170f874e017b44373c86de",
        "rest":
            "6ffcb6dd376d3ccc329aace41b4d0b43e33d959d4d812f06332127967426c844",
    },
    "terrain512-bvh/8589934597": {
        "positions":
            "1d57521c8abae7feb5924ed01822d67e4c59ee8fdb17583330515924635f91f9",
        "uvs":
            "dbc2cab195fb2f105fe638b581db72069dad56f7d254954a29c60b9a7e7ec66e",
        "normals":
            "cb13c348fb4a8a3f5d9410e54d6d3a9dd26eed0c51b0cbec712621fab7b734c2",
        "faces":
            "245ec915e5cba6d086c4d669153f91bd79b9a0e0cd6f6b7cccd51e04d55ecfa4",
        "texture_u8":
            "03dec0c25e2a3183d85e32ff6c8cbb0e3b716df7f78dd28c564e6f02e383150a",
        "rest":
            "6ffcb6dd376d3ccc329aace41b4d0b43e33d959d4d812f06332127967426c844",
    },
}

# the asset files' bytes
ASSETS = {
    "refscene-terrain91/7": {
        "mesh.obj":
            "d3cd21d952fba9dfa08aa95df612196ff409481c55123e7fc8b82665c45a5872",
        "mesh.mtl":
            "c31275f50d23dd6383fcd7a8da08b9dc56cae340b359744fa4e135460aa0b0bd",
        "albedo.png":
            "0d095c2390c0b2bc9432085df6634fe544e3bc3cd12b2a6b914439a89df06665",
    },
    "refscene-terrain91/2147483904": {
        "mesh.obj":
            "3d01c42854b9c258fc9532cdc7229ebd5b44e36d4851b4df8e9b4430f0c02e65",
        "mesh.mtl":
            "c31275f50d23dd6383fcd7a8da08b9dc56cae340b359744fa4e135460aa0b0bd",
        "albedo.png":
            "ff1d9622c60eac7ce8d6c3841f003f6b9a81b0810e488dc190593fe3a931188a",
    },
    "refscene-terrain91/3000000011": {
        "mesh.obj":
            "6b21f45c28e50f67e9b01de6ab26909d56ac385b03b7704e7ca94d4182a1cb7c",
        "mesh.mtl":
            "c31275f50d23dd6383fcd7a8da08b9dc56cae340b359744fa4e135460aa0b0bd",
        "albedo.png":
            "7553cf9dcd976bcab49f3128cd76a6eda57405af817deeeb8a78843fd513d3b5",
    },
    "refscene-terrain91/8589934597": {
        "mesh.obj":
            "0158dbb7b8fd1e9bc1e0ffd79cacd817c1653fb022f39d05f6830b2509388b0b",
        "mesh.mtl":
            "c31275f50d23dd6383fcd7a8da08b9dc56cae340b359744fa4e135460aa0b0bd",
        "albedo.png":
            "74767ecb404e88e58448fbcdb2f8966ca631e65b28d41cc41923966dc209bdf8",
    },
    "terrain512-bvh/7": {
        "mesh.obj":
            "575cb1545c527badad4794f962b098fbbe08a6077fc7023289e7220210dbcb14",
        "mesh.mtl":
            "c31275f50d23dd6383fcd7a8da08b9dc56cae340b359744fa4e135460aa0b0bd",
        "albedo.png":
            "0d095c2390c0b2bc9432085df6634fe544e3bc3cd12b2a6b914439a89df06665",
    },
    "terrain512-bvh/2147483904": {
        "mesh.obj":
            "4a87569cf0a35773c1444274d907b70c292f9e64541064e425d7114289ead9b3",
        "mesh.mtl":
            "c31275f50d23dd6383fcd7a8da08b9dc56cae340b359744fa4e135460aa0b0bd",
        "albedo.png":
            "ff1d9622c60eac7ce8d6c3841f003f6b9a81b0810e488dc190593fe3a931188a",
    },
    "terrain512-bvh/3000000011": {
        "mesh.obj":
            "a62b4789249b24e3a27eca847c78be66304b7e6cc71133189f817b4cff9945bc",
        "mesh.mtl":
            "c31275f50d23dd6383fcd7a8da08b9dc56cae340b359744fa4e135460aa0b0bd",
        "albedo.png":
            "7553cf9dcd976bcab49f3128cd76a6eda57405af817deeeb8a78843fd513d3b5",
    },
    "terrain512-bvh/8589934597": {
        "mesh.obj":
            "4686c3f1e61366720721477938f7d515b79f4a43903db0f29241f3aabb83a8ea",
        "mesh.mtl":
            "c31275f50d23dd6383fcd7a8da08b9dc56cae340b359744fa4e135460aa0b0bd",
        "albedo.png":
            "74767ecb404e88e58448fbcdb2f8966ca631e65b28d41cc41923966dc209bdf8",
    },
}

# repr of the program's SceneConfig, the OBJ named "mesh.obj"
SCENE_CONFIG = {
    "refscene-terrain91.orbit-1080p/7":
        "94a5b445bc72d4643d875146a5c48d6d70c21510aa0d36acfea80102bac713c5",
    "refscene-terrain91.pt4-1080p/7":
        "591c70f2c2956e6d47eda98ab01e00c7f20ef20e9f2cbecc438c0fd228454f2a",
    "refscene-terrain91.orbit-1080p/2147483904":
        "e056253568307b2a797caf6df16fb41cb860fd551abbe854612bd2fbebbe8eb3",
    "refscene-terrain91.pt4-1080p/2147483904":
        "0a8b189a18f9901b7c56d30c50e0a2855a5f373a49f2a2fb73f1b1de720322fc",
    "refscene-terrain91.orbit-1080p/3000000011":
        "b2592116cf0208e20d219936700c6dff5abcb8afd7ef61c1adfab929a151b426",
    "refscene-terrain91.pt4-1080p/3000000011":
        "e158c988354752ba86df55a31426cac9e1b9af680395021b274bbc46142b92c3",
    "refscene-terrain91.orbit-1080p/8589934597":
        "88b6bf58449e87b99b2365f1a3abf22fef5eed440754696ab329c53eb07734a1",
    "refscene-terrain91.pt4-1080p/8589934597":
        "ce9a5169896a32782d5a67a96d14e593d539fc6253f0e4837ce4310f1b78067f",
    "terrain512-bvh.orbit-1080p/7":
        "532bdd52bc1e12c065ffcf551b9d130234e093fb157bfe772679e627ba896fd8",
    "terrain512-bvh.pt3-540p/7":
        "0b542ac0bf1b1b94e747c94d80b00bc68d6fcd4f430545c1f253fb0caaa01026",
    "terrain512-bvh.orbit-1080p/2147483904":
        "af153e97e231fb90b06d28052a47dd6aa2df3162c2cc8a1263599b867cd80fba",
    "terrain512-bvh.pt3-540p/2147483904":
        "a305a3141d98e6a4171dea6e15c555647652bf1d92bfde04bf183da854c06083",
    "terrain512-bvh.orbit-1080p/3000000011":
        "7f3061de259192149d8555a164adec8b065b93345fde8ac284b8e7d6d5f58978",
    "terrain512-bvh.pt3-540p/3000000011":
        "5d4664c41dad7bd025f980050b5763697d71c1fc339ce91e2a6a057aef998ea4",
    "terrain512-bvh.orbit-1080p/8589934597":
        "d6ec9f637fa76c4642e3c53e53f8113778e0572ca5b8bab0713a25ebfe4c4444",
    "terrain512-bvh.pt3-540p/8589934597":
        "da4af6bd6b047d595d717b7427e13c50bb400dccfabdff23a991d731648477ef",
}

# the reference's float32 values at the sampled pixels of STEPS, in step
# order
REFERENCE = {
    "tiny.orbit/7":
        "6dc2e012de3966de6be942db1a39d65388f03da5f3856d56a34402def8e6cc55",
    "tiny.orbit/2147483904":
        "523b6a84c1aec097fbc3deee4718241a1feae8587e33f2e90638360eb7232329",
    "tiny.orbit/3000000011":
        "6dbee17abddbad640ad8254c8ad2c971cab85c51da4cc7b7ac262ae0a9a4a8e9",
    "tiny.orbit/8589934597":
        "931689e5b03c2d7bbd07774d5ab8ee709de00e4510cb4d02e4424d8bdb89ac29",
    "tiny.pt/7":
        "0a1d8316a0af50c85fa5725858214c2d31b65c837e41ddc47291a47bfadf03c2",
    "tiny.pt/2147483904":
        "860caed36b01fa84c1a16e4aea5697483b42af9d1c78a715eb87f165376c82b7",
    "tiny.pt/3000000011":
        "4f69771c6a690a9cce2fb7474f49168ce4ff320066b374e961490cab97821ecd",
    "tiny.pt/8589934597":
        "062317a5c3ee99aa469ccfbbd01636283ca0a9a53dd259e97195ce14eedd671d",
}


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _array(a) -> str:
    a = np.ascontiguousarray(a)
    return _sha(f"{a.dtype.str}{a.shape}".encode() + a.tobytes())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("conf", sorted(CELLS))
def test_heightfield_kind_keeps_inputs_assets_and_config(conf, seed,
                                                         tmp_path):
    cells = [harness.load_cell(c) for c in CELLS[conf]]
    kind = cells[0].scene
    assert not kind.MOVES and not hasattr(kind, "advance")
    inputs = kind.make_inputs(cells[0].config, seed)
    got = {k: _array(getattr(inputs, k)) for k in ARRAYS}
    got["rest"] = _sha(repr((
        inputs.spheres, inputs.translation, inputs.scale,
        inputs.light_direction, inputs.ambient, inputs.diffuse,
        inputs.specular)).encode())
    key = f"{conf}/{seed}"
    assert got == INPUTS[key]
    assets = kind.write_assets(inputs, str(tmp_path))
    assert assets == "mesh.obj"
    assert sorted(os.listdir(tmp_path)) == sorted(ASSET_FILES)
    assert {f: _sha((tmp_path / f).read_bytes())
            for f in ASSET_FILES} == ASSETS[key]
    for cell in cells:
        replay = traffic.Replay(cell.traffic, cell.config, seed)
        sc = cell.scene.program_config(cell.config, cell.traffic,
                                       replay.start, "mesh.obj", seed)
        assert _sha(repr(sc).encode()) == SCENE_CONFIG[
            f"{cell.name}/{seed}"], cell.name


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(STEPS))
def test_reference_values_keep_their_bits(root, name, seed):
    cell = harness.load_cell(name, root)
    tr = cell.traffic
    replay = traffic.Replay(tr, cell.config, seed)
    inputs = cell.scene.make_inputs(cell.config, seed)
    xs, ys = traffic.pixel_sample(tr, seed, int(tr["check_pixels"]))
    ref = verify.reference_values(cell, inputs, replay, xs, ys,
                                  STEPS[name], seed=seed, device="cpu")
    assert sorted(ref) == sorted(STEPS[name])
    h = hashlib.sha256()
    for g in sorted(ref):
        h.update(ref[g].to(torch.float32).contiguous().numpy().tobytes())
    assert h.hexdigest() == REFERENCE[f"{name}/{seed}"]
