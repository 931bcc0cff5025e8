from kylespathtracer.core import gmath, sampler, color  # noqa: F401
