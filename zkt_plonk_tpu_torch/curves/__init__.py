from .context import CurveCtx, make_context
from . import host as curve_host
from . import pairing
