"""The benchmark's own tests: ``python -m pytest chipbench/tests``. They
import the benchmark's library from its folder and the program from
``src``."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE.parents[1] / "src"))
