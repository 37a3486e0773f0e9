import sys
from pathlib import Path

# The harness is imported as the package ``bench_h100`` from the root of the checkout.
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
