"""The classic OpenCog "animals" sample KB, generated programmatically.

Same facts as the reference sample knowledge base
(reference data/samples/animals.metta): 14 Concept nodes, 7 Similarity
pairs stored in both orientations (26 links total with the 12 Inheritance
edges), used across the test suite for md5 handle parity (e.g.
Concept:human = af12f10f9ae2002a1607ba0b47ba8407).
"""

from __future__ import annotations

CONCEPTS = [
    "human", "monkey", "chimp", "snake", "earthworm", "rhino", "triceratops",
    "vine", "ent", "mammal", "animal", "reptile", "dinosaur", "plant",
]

SIMILARITY_PAIRS = [
    ("human", "monkey"),
    ("human", "chimp"),
    ("chimp", "monkey"),
    ("snake", "earthworm"),
    ("rhino", "triceratops"),
    ("snake", "vine"),
    ("human", "ent"),
]

INHERITANCE_EDGES = [
    ("human", "mammal"),
    ("monkey", "mammal"),
    ("chimp", "mammal"),
    ("mammal", "animal"),
    ("reptile", "animal"),
    ("snake", "reptile"),
    ("dinosaur", "reptile"),
    ("triceratops", "dinosaur"),
    ("earthworm", "animal"),
    ("rhino", "mammal"),
    ("vine", "plant"),
    ("ent", "plant"),
]


def animals_metta() -> str:
    """Render the KB as canonical MeTTa text (typedefs first, then terminal
    typedefs, then expressions; Similarity link set closed under reversal)."""
    lines = ["(: Similarity Type)", "(: Concept Type)", "(: Inheritance Type)"]
    # terminal typedefs in a stable order matching CONCEPTS grouping
    order = [
        "human", "monkey", "chimp", "snake", "earthworm", "rhino",
        "triceratops", "vine", "ent", "mammal", "animal", "reptile",
        "dinosaur", "plant",
    ]
    for name in order:
        lines.append(f'(: "{name}" Concept)')
    for a, b in SIMILARITY_PAIRS:
        lines.append(f'(Similarity "{a}" "{b}")')
    for a, b in INHERITANCE_EDGES:
        lines.append(f'(Inheritance "{a}" "{b}")')
    for a, b in SIMILARITY_PAIRS:
        lines.append(f'(Similarity "{b}" "{a}")')
    return "\n".join(lines) + "\n"


def write_animals_metta(path: str) -> str:
    text = animals_metta()
    with open(path, "w") as fh:
        fh.write(text)
    return path
