from .base import BaseRunner
from .class_inference import ClassInference
from .runner import Runner
