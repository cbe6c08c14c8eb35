from .autocomplete import AutocompleteIndex
from .semantic import SemanticIndex
