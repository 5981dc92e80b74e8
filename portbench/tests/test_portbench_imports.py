"""Nothing the benchmark loads is JAX or the JAX package, compared by whole
top-level module names (the program, ``cdvslam_tpu_torch``, begins with
the JAX package's name)."""
import subprocess
import sys

from portbench import cell

CODE = """
import sys
sys.path.insert(0, {root!r})
from portbench import cell
import portbench.calibrate, portbench.ref.check, portbench.ref.slam.step
import portbench.yardstick.profile, portbench.yardstick.render
from cdvslam_tpu_torch.slam import SLAM
from cdvslam_tpu_torch.config import get_cfg
for m in {readers!r}:
    cell.load_reader(m)
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def test_whole_name_rule():
    sys.modules.setdefault("cdvslam_tpu_torch_probe", sys)
    try:
        assert "cdvslam_tpu" not in cell.forbidden_modules()
    finally:
        del sys.modules["cdvslam_tpu_torch_probe"]


def test_no_jax_in_a_fresh_process():
    readers = [m["name"] for m in cell.load_json(cell.ROOT / "BENCHMARK.json")["per_layer"]]
    out = subprocess.run([sys.executable, "-c", CODE.format(root=str(cell.ROOT), readers=readers)],
                         capture_output=True, text=True, timeout=300, check=True).stdout
    tops = set(eval(out.strip().splitlines()[-1]))
    assert "cdvslam_tpu_torch" in tops
    assert not tops & set(cell.FORBIDDEN), tops & set(cell.FORBIDDEN)
