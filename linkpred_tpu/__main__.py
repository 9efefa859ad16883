"""``python -m linkpred_tpu`` — experiment driver entry point."""
import sys

from .cli import main
from .utils.cache import enable_compile_cache

enable_compile_cache()
sys.exit(main())
