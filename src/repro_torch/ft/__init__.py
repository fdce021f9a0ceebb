from .supervisor import SimulatedFailure, Supervisor
