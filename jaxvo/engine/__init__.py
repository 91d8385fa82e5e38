from jaxvo.engine.state import VOState
from jaxvo.engine.vo import bootstrap, run_sequence, track_step

__all__ = ["VOState", "bootstrap", "run_sequence", "track_step"]
