"""What the port does not run yet, by the ROADMAP.md item it waits on.

A leaf, mode or option that is not ported raises :func:`not_ported`
naming its item of ROADMAP.md's Queue 1. The items' labels live here,
in a module that imports nothing of the package, so that any module can
name one without importing another.
"""

OTHER_FACTORIES = "other optax factories"


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, Queue 1: {item})"
    )
