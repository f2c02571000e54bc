from .runner import Runner
