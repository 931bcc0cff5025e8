from kylespathtracer.scene.types import Scene, Materials, OBJ  # noqa: F401
from kylespathtracer.scene.scene import default_scene  # noqa: F401
