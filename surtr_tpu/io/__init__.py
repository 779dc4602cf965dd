"""Asset IO — this framework's answer to the reference's Assimp path (SURVEY §2.2
T3): host-side OBJ parsing + vertex welding + padded device buffers."""
