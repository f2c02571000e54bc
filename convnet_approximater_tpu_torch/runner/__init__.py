from .class_inference import BaseRunner, ClassInference
from .runner import Runner
