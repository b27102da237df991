import sys
from pathlib import Path

# the port's package, as ``run.py`` finds it
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
