from .profiling import enable_nan_checks, trace
from .tb_writer import TBWriter
