/* Byte-trie leftmost-longest vocabulary matcher.
 *
 * Native backend for coati_tpu.tokenizers.matcher.VocabMatcher: the
 * host-side tokenizer is the input-pipeline hot loop (every training row
 * is trie-split twice), so the inner scan lives here. Exposed through a
 * minimal C ABI consumed via ctypes — no pybind11 dependency.
 *
 * Semantics match the Python implementation exactly: scan left to right,
 * at each position take the LONGEST vocabulary token starting there;
 * unmatched bytes accumulate into passthrough spans.
 *
 * The trie is a flat array of nodes, each holding a 256-way child table
 * (int32 indices; -1 = absent) and a terminal flag. Memory is traded for
 * branchless byte-indexed walks (SMILES vocabs are ~10-15k short tokens,
 * a few MB of nodes).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    int32_t children[256];
    uint8_t terminal;
} Node;

typedef struct {
    Node *nodes;
    int32_t n_nodes;
    int32_t cap;
} Matcher;

static int32_t new_node(Matcher *m) {
    if (m->n_nodes == m->cap) {
        m->cap *= 2;
        m->nodes = (Node *)realloc(m->nodes, (size_t)m->cap * sizeof(Node));
    }
    Node *n = &m->nodes[m->n_nodes];
    memset(n->children, 0xff, sizeof(n->children)); /* all -1 */
    n->terminal = 0;
    return m->n_nodes++;
}

Matcher *matcher_new(void) {
    Matcher *m = (Matcher *)malloc(sizeof(Matcher));
    m->cap = 1024;
    m->n_nodes = 0;
    m->nodes = (Node *)malloc((size_t)m->cap * sizeof(Node));
    new_node(m); /* root = 0 */
    return m;
}

void matcher_free(Matcher *m) {
    if (m) {
        free(m->nodes);
        free(m);
    }
}

void matcher_add(Matcher *m, const uint8_t *token, int32_t len) {
    if (len <= 0) return;
    int32_t cur = 0;
    for (int32_t i = 0; i < len; i++) {
        int32_t nxt = m->nodes[cur].children[token[i]];
        if (nxt < 0) {
            nxt = new_node(m); /* may realloc m->nodes */
            m->nodes[cur].children[token[i]] = nxt;
        }
        cur = nxt;
    }
    m->nodes[cur].terminal = 1;
}

/* Split text into pieces. Writes piece boundaries into (starts, ends)
 * and a token/passthrough flag into flags. Returns the piece count
 * (<= max_out; text never produces more pieces than bytes). */
int32_t matcher_split(const Matcher *m, const uint8_t *text, int32_t len,
                      int32_t *starts, int32_t *ends, uint8_t *flags,
                      int32_t max_out) {
    int32_t count = 0;
    int32_t span_start = 0;
    int32_t pos = 0;
    const Node *nodes = m->nodes;
    while (pos < len) {
        /* longest match starting at pos */
        int32_t cur = nodes[0].children[text[pos]];
        int32_t best_end = -1;
        int32_t j = pos + 1;
        while (cur >= 0) {
            if (nodes[cur].terminal) best_end = j;
            if (j >= len) break;
            cur = nodes[cur].children[text[j]];
            j++;
        }
        if (best_end < 0) {
            pos++;
            continue;
        }
        if (pos > span_start && count < max_out) {
            starts[count] = span_start;
            ends[count] = pos;
            flags[count] = 0;
            count++;
        }
        if (count < max_out) {
            starts[count] = pos;
            ends[count] = best_end;
            flags[count] = 1;
            count++;
        }
        pos = best_end;
        span_start = best_end;
    }
    if (span_start < len && count < max_out) {
        starts[count] = span_start;
        ends[count] = len;
        flags[count] = 0;
        count++;
    }
    return count;
}
